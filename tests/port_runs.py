"""Runs shared by the port's dtw-surface tests: chip_smoke.py loaded as a
module (its workload generators), and one run_dtw over a FASTA and a
BLOW5 by the port on the CPU (the kernel's plain PyTorch version) or by
sigfish_tpu on one of its engines, both in batches of BATCH reads on two
threads unless the caller says otherwise."""

from __future__ import annotations

import importlib.util
import io
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 16


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(core, run_dtw):
    out = io.StringIO()
    run_dtw(core, out)
    core.close()
    return out.getvalue(), core


def run_port(fa, bl, state=None, **opt):
    """(output, Core) of the port with device="cpu"."""
    from sigfish_tpu_torch.runtime.pipeline import Core, Options, run_dtw

    opt = {"batch_size": BATCH, "num_thread": 2, **opt}
    return _run(Core(fa, bl, Options(device="cpu", **opt), state=state), run_dtw)


def run_jax(fa, bl, engine, **opt):
    """(output, Core) of sigfish_tpu on engine."""
    from sigfish_tpu.runtime.pipeline import Core, Options, run_dtw

    opt = {"batch_size": BATCH, "num_thread": 2, **opt}
    return _run(Core(fa, bl, Options(engine=engine, **opt)), run_dtw)
