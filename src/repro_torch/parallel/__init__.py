from repro_torch.parallel.sharding import (  # noqa: F401
    ParamSpec,
    init_param,
    init_params,
    init_params_numpy,
    tree_leaves_with_path,
    tree_map_specs,
)
