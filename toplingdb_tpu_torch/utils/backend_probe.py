"""CUDA reachability probe (the counterpart of
toplingdb_tpu/utils/backend_probe.py, for the card).

Anything that may touch the card non-interactively (a bench, a driver
entry point) can probe first in a KILLABLE subprocess: a driver or runtime
fault can hang CUDA's initialisation with no error and no timeout. The
probe records evidence: the child runs with
``faulthandler.dump_traceback_later`` armed, so a hang leaves the exact
blocking stack on its stderr, and the parent keeps the stderr tail.

When the card cannot be reached, `ensure_reachable_backend` RAISES with
that evidence. There is no redirect to the CPU: the reference's
`redirect_to_cpu_backend` and `retry_redirect` are the fallback that would
hide the device, so the port has no counterpart of them, and it reads no
environment variable to decide anything here.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time

from toplingdb_tpu_torch.utils.status import IOError_

# The child arms faulthandler a little inside the parent's budget so ITS
# stack dump (the evidence) wins the race against the parent's SIGKILL.
_CHILD_GRACE_S = 5.0

_PROBE_SRC = r"""
import faulthandler, sys, time
budget = float(sys.argv[1])
faulthandler.dump_traceback_later(budget, exit=True)
t0 = time.time()
import torch
print("probe: import torch ok %.1fs" % (time.time() - t0), file=sys.stderr)
t0 = time.time()
torch.cuda.init()
print("probe: cuda init ok %.1fs %s" % (
    time.time() - t0, torch.cuda.get_device_name(0)), file=sys.stderr)
t0 = time.time()
x = torch.ones((256, 256), dtype=torch.float32, device="cuda:0")
y = (x @ x).sum().item()
torch.cuda.synchronize()
assert y == 256.0 ** 3, y
print("probe: matmul ok %.1fs" % (time.time() - t0), file=sys.stderr)
"""


class BackendUnreachable(IOError_):
    """The card could not be reached; `diagnostics` holds every attempt's
    evidence dict."""

    def __init__(self, msg: str, diagnostics: list):
        super().__init__(msg)
        self.diagnostics = diagnostics


def probe_cuda_backend(timeout_s: float):
    """Run ``import torch; torch.cuda.init(); a small matmul on cuda:0`` in
    a fresh process.

    Returns ``(ok, diag)`` where diag is a JSON-able dict:
    ``{"ok", "elapsed_s", "rc", "stderr_tail"}``. On a hang the child's
    faulthandler stack appears in stderr_tail.

    Runs in its own session: a timeout kills the whole process GROUP (a
    helper the runtime spawns would otherwise hold pipes open past the
    child's death)."""
    import tempfile

    t0 = time.time()
    diag = {"ok": False, "elapsed_s": 0.0, "rc": None, "stderr_tail": ""}
    # Child stderr goes to a FILE, not a pipe: a helper that outlives the
    # child would hold a pipe open and stall the parent past the child's
    # exit; a file fd has no reader to block on, and we read it after
    # wait().
    with tempfile.TemporaryFile() as errf:
        try:
            p = subprocess.Popen(
                [sys.executable, "-u", "-c", _PROBE_SRC,
                 str(max(1.0, timeout_s - _CHILD_GRACE_S))],
                stdout=subprocess.DEVNULL, stderr=errf,
                start_new_session=True,
            )
        except OSError as e:
            diag["stderr_tail"] = f"popen failed: {e!r}"
            return False, diag
        try:
            diag["rc"] = p.wait(timeout=timeout_s)
            diag["ok"] = diag["rc"] == 0
        except subprocess.TimeoutExpired:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except OSError:
                p.kill()
            p.wait()
            diag["rc"] = "killed-after-timeout"
        diag["elapsed_s"] = round(time.time() - t0, 1)
        errf.seek(0, os.SEEK_END)
        size = errf.tell()
        errf.seek(max(0, size - 2000))
        diag["stderr_tail"] = errf.read().decode("utf-8", "replace")
    return diag["ok"], diag


def ensure_reachable_backend(timeout_s: float = 120.0,
                             attempts: int = 1,
                             backoff_s: float = 30.0,
                             diagnostics: list | None = None) -> bool:
    """Returns True when the card is reachable. `attempts` > 1 retries
    with `backoff_s` sleeps, so one transient fault does not decide a
    whole run. Each attempt's evidence dict is appended to `diagnostics`
    when given. When every attempt failed, raises BackendUnreachable with
    the evidence: nothing is redirected to the CPU."""
    evidence = diagnostics if diagnostics is not None else []
    for i in range(max(1, attempts)):
        if i:
            time.sleep(backoff_s)
        ok, diag = probe_cuda_backend(timeout_s)
        diag["attempt"] = i + 1
        evidence.append(diag)
        if ok:
            return True
    last = evidence[-1]
    raise BackendUnreachable(
        f"CUDA device unreachable after {max(1, attempts)} attempt(s): "
        f"rc={last['rc']}, stderr tail: {last['stderr_tail'][-600:]}",
        evidence)
