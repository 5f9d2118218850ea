"""Live retune and telemetry streaming (counterpart of
``quad_periodic_mpc_tpu/utils/live_tune.py``).

The reference exposes two operator surfaces while the robot runs: a
dynamic_reconfigure server for live parameter changes
(be2r_cmpc_unitree/config/ros_dynamic_params.cfg, delivered at
be2r_cmpc_unitree.cpp:733-739) and PlotJuggler layouts reading its ROS
topics (be2r_cmpc_unitree/config/plotjuggler/).  Here:

- ``FileTuner`` watches a JSON file and maps changed values onto a
  ``config.TunableParams`` of tensors.  The running loop applies them by
  writing into the tensors it already holds (``.copy_()``), so a retune
  moves no tensor and reads no tunable back to the host.  ``echo
  '{"alpha": 2e-5}' > tune.json`` is the reconfigure call.
- ``UdpTelemetry`` streams one JSON object per datagram, the format
  PlotJuggler's "UDP Server" source parses.

Both use only the standard library and torch; ``cli.py live`` polls the
tuner between chunks of MPC periods.
"""

from __future__ import annotations

import json
import os
import socket
from typing import Optional

import torch


class FileTuner:
    """Watch a JSON file of TunableParams overrides.

    poll() returns a new TunableParams when the file changed since the last
    call (unknown keys are reported in ``unknown_keys``, not fatal), else
    None; None too while the file is missing or holds a partial write.
    Fields absent from the file keep ``base``'s values.  Each new leaf is a
    tensor on the device of ``base``'s field, in ``dtype`` (default: that
    field's dtype)."""

    def __init__(self, path: str, base, dtype=None):
        self.path = str(path)
        self.base = base                    # TunableParams defaults
        self.dtype = dtype
        self._mtime: Optional[float] = None
        self.unknown_keys: list[str] = []

    def poll(self):
        try:
            mtime = os.stat(self.path).st_mtime
        except OSError:
            return None
        if self._mtime is not None and mtime == self._mtime:
            return None
        self._mtime = mtime
        try:
            with open(self.path) as f:
                raw = json.load(f)
        except (OSError, json.JSONDecodeError):
            return None                     # partial write: retry next poll
        if not isinstance(raw, dict):
            return None
        fields = self.base._fields
        self.unknown_keys = [k for k in raw if k not in fields]
        updates = {}
        for k in fields:
            if k in raw:
                ref = getattr(self.base, k)
                updates[k] = torch.as_tensor(
                    raw[k], dtype=self.dtype or ref.dtype, device=ref.device)
        if not updates:
            return self.base
        return self.base._replace(**updates)


class UdpTelemetry:
    """One JSON object per datagram (PlotJuggler "UDP Server" format)."""

    def __init__(self, host: str, port: int):
        self.addr = (host, int(port))
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def send(self, sample: dict) -> None:
        try:
            self.sock.sendto(json.dumps(sample, allow_nan=True).encode(), self.addr)
        except OSError:
            pass                            # telemetry must never stop the controller

    def close(self) -> None:
        self.sock.close()


def parse_hostport(spec: str, default_port: int = 9870) -> tuple[str, int]:
    host, _, port = spec.partition(":")
    return host or "127.0.0.1", int(port) if port else default_port
