"""The port's multi-host run against sigfish_tpu: the record ranges and
stripes (sigfish_tpu_torch/parallel/distributed.py, `--shard I/N`), and
N-process clusters of `python -m sigfish_tpu_torch.cli dtw --hosts N
--host-id I --coordinator localhost:PORT --device cpu` whose merged
output is byte-identical to sigfish_tpu's single-process run. A dead
peer, at join or mid-run, fails host 0 within the gather timeout with
that peer named. Every subprocess has a time limit, so a hang fails its
test instead of stalling the suite. `--trace DIR` writes a profiler
trace and leaves the PAF as it was.

Workloads are chip_smoke.py's generators at a tiny size (600 bases, 32
DNA reads; 4 transcripts, 24 RNA reads), mapped in batches of 4 reads
(-K 4), so each host drains several batches.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

import pytest
import torch

from port_runs import REPO, load_smoke, run_jax
from sigfish_tpu.io.blow5 import Slow5File as JSlow5File
from sigfish_tpu.output import sam_header
from sigfish_tpu.parallel import distributed as jdist
from sigfish_tpu_torch import __version__, cli
from sigfish_tpu_torch.io.blow5 import Slow5File
from sigfish_tpu_torch.parallel import distributed as tdist

K = 4                  # -K: reads a batch
PROC_TIMEOUT = 180     # seconds a cluster's processes may take in all
GATHER_TIMEOUT_MS = 10_000
RNA = ["--rna", "-q", "500", "-p", "-1"]


@pytest.fixture(scope="module")
def dna(tmp_path_factory):
    d = tmp_path_factory.mktemp("dna")
    return load_smoke().make_workload(str(d), 600, 32, 7)[:2]


@pytest.fixture(scope="module")
def rna(tmp_path_factory):
    d = tmp_path_factory.mktemp("rna")
    return load_smoke().make_rna_workload(str(d), 4, 24, 8, tx_len=(600, 900))[:2]


@pytest.fixture(scope="module")
def dna8(dna, tmp_path_factory):
    """The DNA workload's first 8 reads: a profiler trace of the plain
    versions records every op of their loops, tens of MB a batch."""
    bl8 = str(tmp_path_factory.mktemp("dna8") / "reads8.blow5")
    load_smoke().subset_blow5(dna[1], bl8, {f"read{i:05d}" for i in range(8)})
    return dna[0], bl8


@pytest.fixture(scope="module")
def dna_single(dna):
    """sigfish_tpu's single-process PAF of the DNA workload, and its Core."""
    return run_jax(*dna, "native", batch_size=K)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict[str, str]:
    env = {k: v for k, v in os.environ.items()
           if k not in ("SIGFISH_TPU_DIE_AFTER_BATCH", "SIGFISH_HOSTS", "SIGFISH_HOST_ID",
                        "SIGFISH_COORDINATOR")}
    env.update(extra)
    return env


def _wait_all(procs, errs, timeout=PROC_TIMEOUT):
    """(return codes, stderr texts) of procs, each writing its stderr to
    the file errs[i]; kills every process and fails the test once the
    time limit passes."""
    deadline = time.time() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        pytest.fail(f"a process ran past {timeout} s: " + " | ".join(
            open(e).read()[-600:] for e in errs))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], [open(e).read() for e in errs]


def _spawn(cmds, envs, errs):
    procs = []
    for cmd, env, err in zip(cmds, envs, errs):
        with open(err, "w") as fh:
            procs.append(subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL, stderr=fh,
                                          cwd=REPO))
    return procs


def _cluster(argv, n, tmp, envs=None, tag="h"):
    """Run an n-host cluster of the port's CLI over argv (FASTA, BLOW5,
    options); returns (outs, rcs, errs). A free port taken again before
    host 0 binds it retries the whole cluster once; nothing else does."""
    envs = envs or [_env() for _ in range(n)]
    for attempt in range(2):
        port = _free_port()
        outs = [str(tmp / f"{tag}{i}.out") for i in range(n)]
        errs = [str(tmp / f"{tag}{i}.err") for i in range(n)]
        for o in outs:
            if os.path.exists(o):
                os.remove(o)
        cmds = [[sys.executable, "-m", "sigfish_tpu_torch.cli", "dtw", *argv, "--device", "cpu",
                 "--hosts", str(n), "--host-id", str(i), "--coordinator", f"localhost:{port}",
                 "-o", outs[i]] for i in range(n)]
        rcs, texts = _wait_all(_spawn(cmds, envs, errs), errs)
        if attempt == 0 and any("EADDRINUSE" in t or "ddress already in use" in t for t in texts):
            continue
        return outs, rcs, texts


def _ok_cluster(argv, n, tmp, envs=None, tag="h"):
    """Host 0's output of a cluster every host of which exits 0; the
    peers never create their -o."""
    outs, rcs, errs = _cluster(argv, n, tmp, envs, tag)
    assert rcs == [0] * n, "\n---\n".join(e[-1500:] for e in errs)
    for o in outs[1:]:
        assert not os.path.exists(o), o
    with open(outs[0]) as fh:
        return fh.read(), errs


def _all_hosts_line(err: str, n: int) -> str:
    return next(ln for ln in err.splitlines() if f"(all {n} hosts)" in ln)


def _counters(core) -> str:
    return (f"total entries: {core.total_reads}\tprefix fail: {core.prefix_fail}"
            f"\tignored: {core.ignored}\ttoo short: {core.too_short}")


# ------------------------------------------------------------ ranges


def test_compute_host_ranges_equals_the_reference_s(tmp_path):
    """The byte-balanced contiguous split of sigfish_tpu, on the same
    BLOW5 of very uneven records: for N = 1..5 (and more hosts than
    records) the same ranges, contiguous, covering every record once,
    each boundary the last record that fits the bytes of the hosts so
    far (or a host's one record when none fits), and each range seeking
    to its first record."""
    import numpy as np

    from sigfish_tpu_torch.io.blow5 import Slow5Record, Slow5Writer

    p = str(tmp_path / "r.blow5")
    rng = np.random.default_rng(5)
    sizes = [10, 5000, 20, 3000, 40, 60, 2500, 8, 700, 1200, 30]
    with Slow5Writer(p, header_data=[{}]) as w:
        for i, n in enumerate(sizes):
            w.write_record(Slow5Record(
                read_id=f"r{i}", read_group=0, digitisation=8192.0, offset=0.0, range=1400.0,
                sampling_rate=4000.0, raw_signal=rng.integers(-500, 500, n).astype(np.int16)))
    with Slow5File(p) as sf, JSlow5File(p) as jsf:
        idx = sf.index_load()
        rec_bytes = [sz for _, sz in sorted(idx.get(r) for r in idx.ids())]
        total = sum(rec_bytes)
        for n_hosts in (1, 2, 3, 4, 5, 16):
            got = tdist.compute_host_ranges(sf, n_hosts)
            want = jdist.compute_host_ranges(jsf, n_hosts)
            assert [vars(r) for r in got] == [vars(r) for r in want]
            pos = 0
            for h, r in enumerate(got):
                assert r.rec_start == pos
                pos += r.n_records
                if h < n_hosts - 1:
                    share = total * (h + 1) / n_hosts
                    assert sum(rec_bytes[:pos]) <= share or r.n_records <= 1
                    assert pos == len(sizes) or sum(rec_bytes[: pos + 1]) > share
                if r.n_records:
                    sf.seek_record(r.file_offset, r.rec_start)
                    assert sf.decode_record(sf.read_next_blob()).read_id == f"r{r.rec_start}"
            assert pos == len(sizes)


def test_init_distributed_one_process_is_a_no_op():
    tdist.init_distributed("localhost:1", 1, 0)
    assert tdist._cluster is None
    tdist.shutdown_distributed()  # nothing joined: nothing to leave
    with pytest.raises(RuntimeError, match="not initialized"):
        tdist._kv_store()


# ------------------------------------------------------------ --shard


@pytest.mark.parametrize("n", [2, 3])
def test_shard_stripes_equal_the_reference_s(dna, dna_single, tmp_path, n):
    """`--shard I/N` maps the records whose index is I mod N, in file
    order, with sigfish_tpu's Options(shard_id=I, n_shards=N) bytes; the
    N stripes partition the single-process run."""
    full = dna_single[0].splitlines(keepends=True)
    stripes = []
    for i in range(n):
        out = tmp_path / f"s{i}.paf"
        assert cli.main(["dtw", *dna, "--device", "cpu", "-K", str(K), "-t", "2",
                         "--shard", f"{i}/{n}", "-o", str(out)]) == 0
        got = out.read_text()
        want, _ = run_jax(*dna, "native", batch_size=K, shard_id=i, n_shards=n)
        assert got == want and got
        assert got == "".join(ln for ln in full if int(ln.split("\t")[0][4:]) % n == i)
        stripes.append(got)
    assert sorted("".join(stripes).splitlines(keepends=True)) == sorted(full)


# ------------------------------------------------------------ clusters


@pytest.mark.parametrize("n", [2, 3])
def test_cluster_byte_identical(dna, dna_single, tmp_path, n):
    """An n-host DNA cluster: host 0's file is sigfish_tpu's
    single-process PAF byte for byte, and its `(all n hosts)` counters
    are the single run's. The gather streams in 128-byte chunks under a
    2-chunk credit window."""
    env = dict(SIGFISH_GATHER_CHUNK="128", SIGFISH_GATHER_WINDOW="2")
    merged, errs = _ok_cluster([*dna, "-K", str(K), "-t", "2"], n, tmp_path,
                               [_env(**env) for _ in range(n)])
    single, core = dna_single
    assert merged == single and len(merged) > 3 * 128
    assert _all_hosts_line(errs[0], n).endswith(_counters(core))
    assert all("(all" not in e for e in errs[1:])


def test_cluster_rna_byte_identical(rna, tmp_path):
    """A 2-host direct-RNA cluster (`--rna -q 500 -p -1`: the polyA
    autodetect, 3'-end tracks, reversed queries) gives sigfish_tpu's
    single-process PAF."""
    merged, _ = _ok_cluster([*rna, *RNA, "-K", str(K), "-t", "2"], 2, tmp_path)
    single, core = run_jax(*rna, "native", batch_size=K, rna=True, query_size=500,
                           prefix_size=-1)
    assert merged == single and core.prefix_fail >= 0 and len(single.splitlines()) == 24


def test_cluster_sam_header_once_and_traced(dna8, tmp_path):
    """A 2-host `--sam --trace DIR` cluster (8 reads, 2 a batch): host 0
    writes the header once, then every host's records in host order
    (sigfish_tpu's single-process SAM); the counters line reads (all 2
    hosts) with the single-process totals; each host writes its own
    trace file."""
    trace = tmp_path / "trace"
    merged, errs = _ok_cluster([*dna8, "-K", "2", "-t", "2", "--sam", "--trace", str(trace)],
                               2, tmp_path)
    body, core = run_jax(*dna8, "native", batch_size=2, sam=True)
    j = core.ref
    assert merged == sam_header(j.ref_names, j.ref_lengths, __version__) + body
    assert merged.count("@PG") == 1 and merged.count("@SQ") == len(j.ref_names)
    assert len(body.splitlines()) == 8
    assert _all_hosts_line(errs[0], 2).endswith(_counters(core))
    for h in range(2):
        with open(cli.trace_path(str(trace), h)) as fh:
            assert json.load(fh)["traceEvents"]


def test_gather_stream_in_host_order(tmp_path):
    """gather_ordered_stream over three processes with
    SIGFISH_GATHER_CHUNK=128 and SIGFISH_GATHER_WINDOW=2: host 0's
    output is every host's body in host order (several chunks each,
    one host empty), then gather_counters sums, then the exit barrier."""
    out = tmp_path / "merged.txt"
    code = (
        "import io, sys, tempfile\n"
        "from sigfish_tpu_torch.parallel import distributed as d\n"
        "port, h = sys.argv[1], int(sys.argv[2])\n"
        "d.init_distributed(f'localhost:{port}', 3, h)\n"
        "body = tempfile.TemporaryFile('w+b')\n"
        "body.write(b''.join(b'host%d line %03d\\n' % (h, i) for i in range(0 if h == 1 else 40)))\n"
        "sink = io.StringIO()\n"
        "d.gather_ordered_stream(body, sink, h, 3)\n"
        "tot = d.gather_counters({'reads': 10 + h, 'bytes': 7}, h, 3)\n"
        "if h == 0:\n"
        f"    open({str(out)!r}, 'w').write(sink.getvalue() + repr(sorted(tot.items())))\n"
        "d.shutdown_distributed()\n"
    )
    for attempt in range(2):
        port = _free_port()
        errs = [str(tmp_path / f"g{h}.err") for h in range(3)]
        env = _env(SIGFISH_GATHER_CHUNK="128", SIGFISH_GATHER_WINDOW="2")
        rcs, texts = _wait_all(_spawn([[sys.executable, "-c", code, str(port), str(h)]
                                       for h in range(3)], [env] * 3, errs), errs)
        if attempt == 0 and any("EADDRINUSE" in t or "ddress already in use" in t for t in texts):
            continue
        break
    assert rcs == [0, 0, 0], texts
    want = "".join(f"host{h} line {i:03d}\n" for h in (0, 2) for i in range(40))
    assert len(want) > 5 * 128
    assert out.read_text() == want + repr([("bytes", 21), ("reads", 33)])


# ------------------------------------------------------------ dead peers


def test_gather_timeout_names_a_dead_peer(tmp_path):
    """A peer that joins and exits without contributing: host 0's gather
    fails within SIGFISH_GATHER_TIMEOUT_MS, naming host 1 and the
    timeout, instead of waiting for ever."""
    port = _free_port()
    join = ("from sigfish_tpu_torch.parallel.distributed import init_distributed, "
            f"gather_ordered_stream\ninit_distributed('localhost:{port}', 2, %d)\n")
    host0 = join % 0 + (
        "import io, sys, tempfile\n"
        "try:\n"
        "    gather_ordered_stream(tempfile.TemporaryFile(), io.StringIO(), 0, 2)\n"
        "except RuntimeError as e:\n"
        "    sys.exit(f'host 0 failed: {e}')\n"
    )
    env = _env(SIGFISH_GATHER_TIMEOUT_MS=str(GATHER_TIMEOUT_MS))
    errs = [str(tmp_path / "d0.err"), str(tmp_path / "d1.err")]
    t0 = time.time()
    rcs, texts = _wait_all(_spawn([[sys.executable, "-c", host0],
                                   [sys.executable, "-c", join % 1 + "import os\nos._exit(0)\n"]],
                                  [env, env], errs), errs, timeout=120)
    assert rcs[1] == 0 and rcs[0] != 0, texts
    assert "timed out" in texts[0] and "host 1" in texts[0], texts[0][-800:]
    assert time.time() - t0 < 120


def test_mid_run_peer_death_fails_fast(dna, tmp_path):
    """Host 2 of 3 dies after its first drained batch
    (SIGFISH_TPU_DIE_AFTER_BATCH=1, exit code 9): host 0 exits non-zero
    within the gather timeout naming host 2, and host 1, whose store
    went away with host 0, fails naming host 0. No retry: a hang or an
    unnamed failure here is a fault."""
    envs = [_env(SIGFISH_GATHER_TIMEOUT_MS=str(GATHER_TIMEOUT_MS)) for _ in range(3)]
    envs[2]["SIGFISH_TPU_DIE_AFTER_BATCH"] = "1"
    _, rcs, errs = _cluster([*dna, "-K", str(K), "-t", "2"], 3, tmp_path, envs)
    assert rcs[2] == 9, f"the fault hook did not fire: {errs[2][-500:]}"
    assert rcs[0] != 0, "host 0 exited 0 despite a dead peer"
    assert "host 2" in errs[0] and "timed out" in errs[0], errs[0][-800:]
    assert rcs[1] != 0 and "host 0" in errs[1], errs[1][-800:]


def test_cuda_hosts_without_a_card_fail(dna, tmp_path):
    """Hosts asked for CUDA on a machine without a card fail, each with
    the Core's error: no host falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    port = _free_port()
    errs = [str(tmp_path / f"c{i}.err") for i in range(2)]
    cmds = [[sys.executable, "-m", "sigfish_tpu_torch.cli", "dtw", *dna, "--hosts", "2",
             "--host-id", str(i), "--coordinator", f"localhost:{port}",
             "-o", str(tmp_path / f"c{i}.paf")] for i in range(2)]
    rcs, texts = _wait_all(_spawn(cmds, [_env(), _env()], errs), errs, timeout=120)
    assert rcs == [1, 1], texts
    assert all("CUDA" in t for t in texts), texts


# ------------------------------------------------------------ --trace


def test_trace_on_the_cpu(dna8, tmp_path, capsys):
    """`--trace DIR` on the CPU: the PAF is unchanged (sigfish_tpu's) and
    DIR holds a Chrome trace (JSON) with the run's CPU events and its
    sf.* spans; -v 5 reports each kernel's launches in the process (none
    on the CPU) and the Core's counts (8 records decoded, one 64-row
    bucket a batch)."""
    out, trace = tmp_path / "t.paf", tmp_path / "trace"
    assert cli.main(["dtw", *dna8, "--device", "cpu", "-K", str(K), "-t", "2", "-v", "5",
                     "--trace", str(trace), "-o", str(out)]) == 0
    err = capsys.readouterr().err
    assert ("[DEBUG] kernel launches: sdtw_wavefront=0 sdtw_wavefront_carry=0 alu_peak=0 "
            "events=0 polya_end=0") in err
    counts = next(line for line in err.splitlines() if line.startswith("[DEBUG] counts: "))
    c = dict(kv.split("=") for kv in counts.split(": ", 1)[1].split())
    assert int(c["decode_native"]) + int(c["decode_python"]) == 8
    assert int(c["rows_live"]) + int(c["rows_padded"]) == 64 * (8 // K)
    assert out.read_text() == run_jax(*dna8, "native", batch_size=K)[0]
    with open(cli.trace_path(str(trace), 0)) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert any(e.get("name") == "sf.prep" for e in events)
