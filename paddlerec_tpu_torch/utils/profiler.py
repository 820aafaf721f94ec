"""Step-range profiler hook.

Counterpart of ``paddlerec_tpu/utils/profiler.py`` (the reference's
tools/profiler.py): a ``"key=value;key=value"`` option string selects a
[start, stop) batch range; profiling starts at batch_range[0] and stops (and
optionally exits) at batch_range[1].  The trace is ``torch.profiler``'s, of
the CPU and, where there is one, the card, exported as a Chrome trace
(``trace_<start>_<stop>.json``, viewable in Perfetto or chrome://tracing)
under ``profile_path``.
"""

from __future__ import annotations

import os
import sys
import tempfile
from typing import Optional

import torch

_profiler_step_id = 0
_profiler_options: Optional["ProfilerOptions"] = None
_active: Optional[torch.profiler.profile] = None


class ProfilerOptions:
    """Parse "batch_range=[50,60];profile_path=/tmp/p;exit_on_finished=true"
    (same grammar as tools/profiler.py; paddle-only keys like
    ``state``/``tracer_option`` are accepted and ignored)."""

    def __init__(self, options_str: str):
        self._options = {
            "batch_range": [10, 20],
            "state": "All",
            "sorted_key": "total",
            "tracer_option": "Default",
            # the JAX package's /tmp/paddlerec_tpu_profile, under $TMPDIR
            "profile_path": os.path.join(tempfile.gettempdir(),
                                         "paddlerec_tpu_profile"),
            "exit_on_finished": True,
        }
        for kv in options_str.replace(" ", "").split(";"):
            if not kv:
                continue
            key, _, value = kv.partition("=")
            if key == "batch_range":
                vals = [int(v) for v in
                        value.replace("[", "").replace("]", "").split(",")]
                if len(vals) >= 2 and vals[0] >= 0 and vals[1] > vals[0]:
                    self._options[key] = vals[:2]
            elif key == "exit_on_finished":
                self._options[key] = value.lower() in ("yes", "true", "t", "1")
            elif key in self._options:
                self._options[key] = value

    def __getitem__(self, name):
        return self._options[name]


def _start() -> torch.profiler.profile:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def _stop() -> str:
    """Stop the trace and write it; returns the file's path."""
    global _active
    prof, _active = _active, None
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    lo, hi = _profiler_options["batch_range"]
    root = _profiler_options["profile_path"]
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, f"trace_{lo}_{hi}.json")
    prof.export_chrome_trace(path)
    return path


def reset():
    global _profiler_step_id, _profiler_options
    if _active is not None:
        _stop()
    _profiler_step_id = 0
    _profiler_options = None


def add_profiler_step(options_str: Optional[str] = None) -> None:
    """Call once per batch (the trainer does); starts/stops the trace when
    the step counter crosses the configured range."""
    global _profiler_step_id, _profiler_options, _active
    if not options_str:
        return
    if _profiler_options is None:
        _profiler_options = ProfilerOptions(options_str)
    lo, hi = _profiler_options["batch_range"]
    if _profiler_step_id == lo and _active is None:
        _active = _start()
    elif _profiler_step_id == hi and _active is not None:
        _stop()
        if _profiler_options["exit_on_finished"]:
            sys.exit(0)
    _profiler_step_id += 1
