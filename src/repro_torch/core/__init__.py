from repro_torch.core.agent import Agent, AgentConfig  # noqa: F401
from repro_torch.core.chaos import (ChaosScenario,  # noqa: F401
                                     make_chaos_plan)
from repro_torch.core.faults import (Crash, FaultPlan,  # noqa: F401
                                     LinkFault, Partition)
from repro_torch.core.messages import AppInfo, Msg  # noqa: F401
from repro_torch.core.metrics import AppMetrics, complexity_hint  # noqa: F401
from repro_torch.core.piece_exchange import (PieceExchange,  # noqa: F401
                                             RollingRate, iter_bits)
from repro_torch.core.runtime import (CANCELLED, LinkModel,  # noqa: F401
                                      Node, SimRuntime, ThreadRuntime)
from repro_torch.core.swarm import (plan_broadcast,  # noqa: F401
                                    naive_rounds, rarest_first_order,
                                    rarest_first_order_np)
from repro_torch.core.swarm_arrays import SwarmHub, SwarmState  # noqa: F401
from repro_torch.core.swarm_kernels import (choke_order,  # noqa: F401
                                            cost_orders, island_has,
                                            min_island_cost, rarest_orders)
from repro_torch.core.topology import Topology  # noqa: F401
from repro_torch.core.tracker_server import (TrackerConfig,  # noqa: F401
                                             TrackerServer)
from repro_torch.core.validation import VotingPool, majority_vote  # noqa: F401
from repro_torch.core.workunit import (Application, LeaseTable,  # noqa: F401
                                       Part, PieceInventory, PieceManifest,
                                       find_primes, make_prime_app, mask_of,
                                       mask_nbytes, pieces_of,
                                       register_executable,
                                       resolve_executable)
