"""Step-windowed ``torch.profiler`` tracing: the port's copy of
``elasticdl_tpu/common/profiler.py``, on ``torch.profiler`` in place of
``jax.profiler``.

``--profile_steps=START,END`` on the job: each worker traces its own
training steps with index in [START, END) (1-based, the value of
``trainer.step`` after the step runs) and writes a Chrome trace under
``<log_dir>/profile/worker_<id>/`` (``<host>_<pid>.<ns>.pt.trace.json``,
the name ``torch.profiler.tensorboard_trace_handler`` gives, so
TensorBoard's PyTorch profiler plugin reads the directory).  The
training loop brackets its work with ``before_steps(current, n)`` /
``after_steps(current)``: tracing starts before the first in-window step
runs and stops right after the last.  A trainer that runs K steps per
dispatch (``train_window``) traces the whole windows that overlap the
range: the edges round outward, never silently skip.  A window the loop
has already passed logs a loud warning and captures nothing.

The activities are CPU plus CUDA on a CUDA device (the card's kernels,
the port's hand-written ones among them, appear by name), and CPU alone
on the CPU.  On the card the window's edges synchronize the device, so
the trace holds exactly the kernels its steps launched: none still
running from before it opened, none still queued when it closed.  The
window opens and closes with ``profile_window`` journal events
(``action`` open/close, the window, ``trace_dir``; the close also names
``trace_file``), which ``obs/report.py`` points at.
"""

from __future__ import annotations

import atexit
import os
import socket
import time
from typing import List, Optional

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("common.profiler")


def parse_profile_steps(spec: str):
    """'100,120' -> (100, 120); '' -> None."""
    if not spec:
        return None
    try:
        start, end = (int(s) for s in spec.split(","))
    except ValueError as e:
        raise ValueError(f"--profile_steps must be 'start,end', got {spec!r}") from e
    if not (0 <= start < end):
        raise ValueError(f"--profile_steps needs 0 <= start < end: {spec!r}")
    return start, end


def profiler_activities(device) -> List:
    """``torch.profiler`` activities for a device: CPU and CUDA on a CUDA
    device, CPU alone otherwise."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return activities


class StepProfiler:
    """Starts and stops one ``torch.profiler`` trace as the step counter
    crosses the configured window.  Inactive (all no-ops) when
    unconfigured; ``--profile_steps`` without a log dir raises.  The
    device is the card unless ``device`` says otherwise."""

    def __init__(self, log_dir: str, profile_steps: str, worker_id: int = 0,
                 device="cuda"):
        if profile_steps and not log_dir:
            raise ValueError("--profile_steps requires --tensorboard_log_dir (traces are "
                             "written under it for TensorBoard's profiler plugin)")
        window = parse_profile_steps(profile_steps)
        self._window = window
        self._worker_id = int(worker_id)
        self._dir = os.path.join(log_dir, "profile", f"worker_{worker_id}") if window else ""
        self._activities: List = []
        if window:
            from elasticdl_tpu_torch.common.device import resolve_device

            self._activities = profiler_activities(resolve_device(device))
        self._profile = None
        self._done = False
        #: The Chrome trace written at the window's close ('' before).
        self.trace_file = ""
        if window:
            # A worker that exits mid-window still writes what it traced
            # (atexit; SIGTERM arrives as SystemExit).  stop() is
            # idempotent.
            atexit.register(self.stop)

    @property
    def activities(self) -> List:
        return list(self._activities)

    @property
    def tracing(self) -> bool:
        return self._profile is not None

    def before_steps(self, current_step: int, n: int = 1):
        """About to run steps current_step+1 .. current_step+n: start the
        trace if any of them falls in the window."""
        if self._window is None or self._done or self._profile is not None:
            return
        start, end = self._window
        first, last = current_step + 1, current_step + n
        if first >= end:
            logger.warning("Profile window [%d, %d) already passed at step %d: no trace "
                           "captured (window smaller than the training loop's step "
                           "granularity?)", start, end, current_step)
            self._done = True
            return
        if last >= start:
            try:
                import torch

                # Inside the guard: an unwritable trace dir disables
                # profiling, never training.
                os.makedirs(self._dir, exist_ok=True)
                self._synchronize()
                profile = torch.profiler.profile(activities=self._activities)
                profile.start()
                self._profile = profile
                logger.info("Profiling steps [%d, %d) -> %s", start, end, self._dir)
                self._journal_window("open", at_step=current_step)
            except Exception:
                logger.exception("torch.profiler start failed; profiling disabled")
                self._done = True

    def after_steps(self, current_step: int):
        """Steps up to current_step have run: stop once the last
        in-window step (end - 1) is done."""
        if self._profile is not None and current_step >= self._window[1] - 1:
            self.stop()

    def stop(self):
        atexit.unregister(self.stop)
        profile, self._profile = self._profile, None
        if profile is None:
            return
        self._done = True
        try:
            self._synchronize()
            profile.stop()
            name = f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json"
            path = os.path.join(self._dir, name)
            profile.export_chrome_trace(path)
            self.trace_file = path
            logger.info("Profile trace written to %s", path)
        except Exception:
            logger.exception("torch.profiler stop failed")
        self._journal_window("close")

    def _synchronize(self) -> None:
        import torch

        if torch.profiler.ProfilerActivity.CUDA in self._activities:
            torch.cuda.synchronize()

    def _journal_window(self, action: str, at_step: Optional[int] = None):
        """A ``profile_window`` event, so a timeline (``obs.report``) can
        point at the trace covering a window.  Never raises."""
        try:
            from elasticdl_tpu_torch import obs

            fields = dict(worker_id=self._worker_id, action=action,
                          step_start=self._window[0], step_end=self._window[1],
                          trace_dir=self._dir)
            if at_step is not None:
                fields["at_step"] = int(at_step)
            if action == "close" and self.trace_file:
                fields["trace_file"] = self.trace_file
            obs.journal().record("profile_window", **fields)
        except Exception:
            logger.exception("profile_window journal record failed")
