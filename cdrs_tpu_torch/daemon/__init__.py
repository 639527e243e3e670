"""The always-on streaming daemon around the port's controller.

* ``tailer`` — follow-mode reader of a growing ``.cdrsb`` log (waits out
  a missing file and a torn tail, drains a rotated predecessor, honours
  a stop predicate);
* ``epochs`` — immutable ``PlacementEpoch`` snapshots published by one
  reference swap; readers pin one epoch per request batch;
* ``brownout`` — the lag-driven ladder of degraded modes;
* ``core`` — ``StreamDaemon``: ingest -> carve windows on the
  controller's grid -> ``process_window`` -> publish -> alert ->
  checkpoint with the ingest cursor;
* ``supervise`` — restart with capped backoff after a crash.
"""

from .brownout import RUNGS, BrownoutConfig, BrownoutLadder
from .core import DaemonConfig, StreamDaemon
from .epochs import EpochPublisher, PlacementEpoch
from .supervise import supervise
from .tailer import TailBatch, tail_binary_log

__all__ = ["DaemonConfig", "StreamDaemon", "EpochPublisher", "PlacementEpoch", "TailBatch",
           "tail_binary_log", "RUNGS", "BrownoutConfig", "BrownoutLadder", "supervise"]
