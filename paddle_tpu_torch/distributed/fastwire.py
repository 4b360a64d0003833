"""The port's copy of the framing constants of
``paddle_tpu/distributed/fastwire.py``: the connection magic and the
method bytes.  A frame is ``u8 method | u64 length | payload`` after
both ends exchange ``MAGIC``; a reply is ``u64 length | payload``.  The
two packages use the same bytes, so a worker of either answers a peer
of the other."""
from __future__ import annotations

__all__ = ["MAGIC", "METHODS"]

MAGIC = b"FW1\n"
METHODS = {"SendVariable": 1, "GetVariable": 2,
           "SendVariables": 3, "GetVariables": 4,
           "Predict": 5,
           "HierSend": 6, "HierBarrier": 7, "HierComplete": 8,
           "PrefetchVariable": 9,
           # the disaggregated serving fleet (serving/fleet.py):
           # MigrateKV ships a prompt's KV pages from a prefill worker
           # into a decode worker's pool; FleetCall carries the fleet's
           # control ops as a json head
           "MigrateKV": 10, "FleetCall": 11}
