"""Fault injection and self-healing, host numpy: seeded fault schedules
(``FaultSchedule``), the mutable cluster with durability tiers
(``ClusterState``), the budgeted repair planner (``RepairScheduler``) and
the background scrubber (``Scrubber``).  The controller runs them when
``ControllerConfig.fault_schedule`` is set; ``chaos`` is the CLI entry."""

from .repair import RepairBacklog, RepairReport, RepairScheduler, RepairTask
from .schedule import FaultEvent, FaultSchedule
from .scrub import ScrubConfig, ScrubReport, Scrubber
from .state import ClusterState

__all__ = [
    "ClusterState",
    "FaultEvent",
    "FaultSchedule",
    "RepairBacklog",
    "RepairReport",
    "RepairScheduler",
    "RepairTask",
    "ScrubConfig",
    "ScrubReport",
    "Scrubber",
]
