from repro_torch.parallel.pipeline import (  # noqa: F401
    pipeline_apply,
    pipeline_bubble_fraction,
)
from repro_torch.parallel.sharding import (  # noqa: F401
    ParamSpec,
    init_param,
    init_params,
    init_params_numpy,
    tree_leaves_with_path,
    tree_map_specs,
)
from repro_torch.parallel.weight_torrent import (  # noqa: F401
    broadcast_cost_model,
    cold_start_cost_model,
    torrent_broadcast,
    torrent_broadcast_pieces,
)
