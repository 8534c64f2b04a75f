from repro_torch.cluster.heartbeat import HeartbeatMonitor, MemberState  # noqa: F401
from repro_torch.cluster.coordinator import JobCoordinator, WorkItem  # noqa: F401
from repro_torch.cluster.sdc import SDCValidator  # noqa: F401
from repro_torch.cluster.elastic import ElasticPlan, plan_resize  # noqa: F401
