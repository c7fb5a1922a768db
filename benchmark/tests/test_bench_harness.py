"""The harness: BENCHMARK.json keeps to the contract's shape, more cells
come as data files alone, and a whole run on the CPU (its look for a card
skipped, the mapper's plain versions in place of its kernels) reads
`correct` true when the mapper is sound and false when its timed path is
broken underneath."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import run

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _manifest() -> dict:
    return json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def _copy(tmp) -> str:
    root = str(tmp / "checkout")
    shutil.copytree(BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    return root


def test_manifest_shape():
    b = _manifest()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and b["command"][1].startswith("benchmark/")
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for c in b["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"])) and len(c["source"]) <= 200
        assert json.load(open(os.path.join(ROOT, c["file"])))["name"] == c["name"]
    for w in b["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(BENCH, "traffic", w["traffic"] + ".json"))
    for m in b["end_to_end"] + b["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics", m["name"] + ".py"))


def test_every_metric_moves_an_end_to_end_metric_its_cells_report():
    """Every metric is read in every cell (no entry narrows its cells), so
    each per-layer metric's `moves` is reported wherever it is."""
    b = _manifest()
    assert all("workloads" not in m for m in b["end_to_end"] + b["per_layer"])
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert all(m["moves"] in e2e for m in b["per_layer"])


def test_more_cells_come_as_data(tmp_path):
    """A new configuration, traffic mix and per-layer metric, dropped in as
    files with entries in the manifest, are taken without an edit to any
    file that was there; so is a mapper option that no configuration set
    before (`host_stages`)."""
    from sigfish_tpu_torch.runtime import pipeline as pl

    root = _copy(tmp_path)
    before = {p: open(os.path.join(root, "benchmark", p), "rb").read()
              for p in ("run.py", "traffic.py", "check.py", "trace.py")}
    cfg = json.load(open(os.path.join(BENCH, "configs", "sequin_r9_rna.json")))
    cfg.update(name="tiny_rna", reference=dict(cfg["reference"], count=3),
               mapper=dict(cfg["mapper"], host_stages="device", dtw_std=True))
    json.dump(cfg, open(os.path.join(root, "benchmark", "configs", "tiny_rna.json"), "w"))
    tr = json.load(open(os.path.join(BENCH, "traffic", "zlib.json")))
    json.dump(dict(tr, reads=8), open(os.path.join(root, "benchmark", "traffic", "few.json"), "w"))
    with open(os.path.join(root, "benchmark", "metrics", "reads_seen.py"), "w") as f:
        f.write("def read(ctx):\n    return float(ctx.reads_done)\n")
    b = _manifest()
    b["configs"].append(dict(b["configs"][0], name="tiny_rna", file="benchmark/configs/tiny_rna.json"))
    b["workloads"].append(dict(name="tiny_rna.few", config="tiny_rna", traffic="few", chips=1, why="t"))
    b["per_layer"].append(dict(name="reads_seen", unit="reads", better="higher", source="program_counter",
                               layer="decode", moves="reads_per_s"))
    json.dump(b, open(os.path.join(root, "BENCHMARK.json"), "w"))

    spec = run.resolve(root, "tiny_rna.few")
    assert spec["config"]["reference"]["count"] == 3 and spec["traffic"]["reads"] == 8
    assert "reads_seen" in [m["name"] for m in spec["per_layer"]]
    seen = [m for m in spec["per_layer"] if m["name"] == "reads_seen"][0]["read"]
    assert seen(type("C", (), {"reads_done": 5})) == 5.0
    assert "reads_seen" in [m["name"] for m in run.resolve(root, "ecoli_r9_dna.raw")["per_layer"]]
    opt = run.mapper_options(pl, spec["config"], "cpu")
    assert (opt.host_stages, opt.dtw_std, opt.rna, opt.query_size, opt.pore) == ("device", True, True, 500, "r9")
    # the command takes the cell: with no card it stops at the card's check
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "tiny_rna.few", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=root, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0 and r.stdout == ""
    assert "needs 1 CUDA card" in r.stderr or "No module named 'sigfish_tpu_torch'" in r.stderr
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "nope", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=root, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and "unknown workload" in r.stderr
    assert all(open(os.path.join(root, "benchmark", p), "rb").read() == v for p, v in before.items())


def _tiny_root(tmp_path, ref_chunk: int = 0) -> str:
    root = _copy(tmp_path)
    cfg = json.load(open(os.path.join(BENCH, "configs", "ecoli_r9_dna.json")))
    cfg.update(name="tiny", reference=dict(cfg["reference"], bases=5000),
               mapper=dict(cfg["mapper"], num_thread=2, ref_chunk=ref_chunk))
    json.dump(cfg, open(os.path.join(root, "benchmark", "configs", "tiny.json"), "w"))
    tr = json.load(open(os.path.join(BENCH, "traffic", "zlib.json")))
    json.dump(dict(tr, reads=48), open(os.path.join(root, "benchmark", "traffic", "tiny.json"), "w"))
    b = _manifest()
    b["configs"] = [dict(b["configs"][0], name="tiny", file="benchmark/configs/tiny.json")]
    b["workloads"] = [dict(name="tiny.tiny", config="tiny", traffic="tiny", chips=1, why="t")]
    json.dump(b, open(os.path.join(root, "BENCHMARK.json"), "w"))
    return root


def _run_cpu(root: str, capsys, trace: int = 0) -> dict:
    rc = run.run(["--workload", "tiny.tiny", "--seed", str(2**31 + 3), "--seconds", "0.5",
                  "--trace", str(trace)], device="cpu", root=root)
    out = capsys.readouterr()
    assert rc == 0, out.err[-3000:]
    res = json.loads(out.out.strip().splitlines()[-1])
    assert list(res)[-1] == "checks"
    assert out.err.strip().splitlines()[-1].startswith("check lost_reads")
    return res


def test_a_sound_run_is_correct(tmp_path, capsys):
    res = _run_cpu(_tiny_root(tmp_path), capsys, trace=1)
    assert res["correct"] is True
    assert res["checks"]["wrong_lines"]["value"] == 0 and res["attempted"] >= 48
    assert {"parse_ms_per_read", "host_stages_ms_per_read"} <= set(res["metrics"])


def _fault_state_unchanged(monkeypatch):
    from sigfish_tpu_torch.ops import chunked_ref

    real = chunked_ref.sdtw_wavefront_carry

    def stuck(queries, y, rs, a1, a2, ywin, rswin, *a, **kw):
        scores = real(queries, y, rs, a1, a2, ywin, rswin, *a, **kw)[0]
        return scores, a1, a2, ywin, rswin
    monkeypatch.setattr(chunked_ref, "sdtw_wavefront_carry", stuck)


def _fault_half_batch(monkeypatch):
    from sigfish_tpu_torch.runtime import pipeline as pl

    real = pl.submit_batch
    monkeypatch.setattr(pl, "submit_batch", lambda core, blobs: real(core, blobs[: len(blobs) // 2]))


def _fault_answer_altered(monkeypatch):
    from sigfish_tpu_torch.runtime import pipeline as pl

    real = pl.paf_line

    def altered(*a):
        a = list(a)
        a[7] += 1  # pos_st
        return real(*a)
    monkeypatch.setattr(pl, "paf_line", altered)


@pytest.mark.parametrize("fault,ref_chunk", [
    (_fault_state_unchanged, 1500),   # a carry step hands on its state unchanged
    (_fault_half_batch, 0),           # half of each batch left out
    (_fault_answer_altered, 0),       # an answer altered where it is produced
])
def test_a_broken_timed_path_is_not_correct(fault, ref_chunk, tmp_path, capsys, monkeypatch):
    root = _tiny_root(tmp_path, ref_chunk)
    fault(monkeypatch)
    res = _run_cpu(root, capsys)
    assert res["correct"] is False
    assert res["checks"]["wrong_lines"]["value"] > 0 or res["checks"]["lost_reads"]["value"] > 0
