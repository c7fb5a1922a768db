"""The rest of the port's DNA dtw surface on the CPU (the kernel's plain
PyTorch version) against sigfish_tpu: --sam (header and body) and
--from-end byte-identical to its native engine and its Pallas wavefront
engine (interpret mode), through the library and the CLI; --secondary
yes leaves the bytes unchanged, as in the reference, which parses it and
never prints it; the CLI's cross-flag errors are the JAX CLI's, message
and exit code.

Workload: chip_smoke.py's DNA generator at a small size, a 2,000-base
contig (both strands) and 30 reads in two batches, one in ten clipped
(fewer events than -p 50 -q 250 need), so --from-end clips them too.
"""

from __future__ import annotations

import pytest
from port_runs import BATCH, load_smoke, run_jax, run_port

N_BASES = 2_000
N_READS = 30
SEED = 8

FLAGS = {
    "sam": dict(sam=True),
    "from_end": dict(from_end=True),
    "from_end_sam": dict(from_end=True, sam=True),
}


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_surface")
    return load_smoke().make_workload(str(d), N_BASES, N_READS, SEED)


@pytest.fixture(scope="module")
def port_runs(workload):
    """The port's run of each flag set, and of the default PAF run."""
    fa, bl, _ = workload
    runs = {name: run_port(fa, bl, **kw) for name, kw in FLAGS.items()}
    runs["paf"] = run_port(fa, bl)
    return runs


@pytest.mark.parametrize("engine", ["native", "pallas"])
@pytest.mark.parametrize("name", sorted(FLAGS))
def test_surface_matches_jax(workload, port_runs, name, engine):
    """Bytes and counters of --sam, --from-end and both together equal
    the JAX package's, clipped reads included."""
    fa, bl, _ = workload
    got, core = port_runs[name]
    want, jcore = run_jax(fa, bl, engine, **FLAGS[name])
    assert len(got.splitlines()) >= N_READS - 2
    assert got == want
    for c in ("total_reads", "prefix_fail", "ignored", "too_short"):
        assert getattr(core, c) == getattr(jcore, c), c
    assert core.too_short >= 2  # the clipped reads


def test_sam_records_are_the_paf_mappings(port_runs):
    """One SAM record per PAF line, same read, strand and start; the
    ss:Z: tag holds the path (no degenerate alignment)."""
    paf = [ln.split("\t") for ln in port_runs["paf"][0].splitlines()]
    sam = [ln.split("\t") for ln in port_runs["sam"][0].splitlines()]
    assert len(sam) == len(paf)
    for p, s in zip(paf, sam):
        assert s[0] == p[0]
        assert s[1] == ("0" if p[4] == "+" else "16")
        assert s[2] == p[5] and int(s[3]) == int(p[7]) + 1
        assert s[-1].startswith("ss:Z:") and len(s[-1]) > len("ss:Z:\n")


def test_from_end_takes_the_exact_path(workload, port_runs):
    """--from-end maps the read's last events: every query window ends 50
    events before the read's last, which the prefix-bounded eventizer
    cannot know, so each read is eventized whole."""
    from sigfish_tpu_torch.runtime import pipeline as tp

    fa, bl, _ = workload
    core = tp.Core(fa, bl, tp.Options(num_thread=1, device="cpu", from_end=True))
    for blob in core.sf.read_batch(N_READS, 1 << 40):
        w = tp._prepare_read(core, blob)
        exact = tp._event_single(core, tp._parse_single(core, blob))
        assert w.n_events == exact.n_events
        assert w.qend == w.n_events - 50 and w.qstart == max(0, w.qend - 250)
    core.close()
    assert port_runs["from_end"][0] != port_runs["paf"][0]


def test_secondary_leaves_the_bytes_unchanged(workload, port_runs):
    fa, bl, _ = workload
    assert run_port(fa, bl, secondary=True)[0] == port_runs["paf"][0]
    assert run_port(fa, bl, secondary=True, sam=True)[0] == port_runs["sam"][0]


@pytest.mark.parametrize("secondary", ["yes", "no"])
def test_cli_sam_header_and_body(workload, port_runs, tmp_path, secondary):
    """`dtw --sam` through the port's CLI writes the JAX CLI's bytes: the
    @SQ/@PG header, then the body of the library run."""
    from sigfish_tpu import cli as jcli
    from sigfish_tpu_torch import cli

    fa, bl, _ = workload
    common = [fa, bl, "--sam", "-K", str(BATCH), "-t", "2", "--secondary", secondary]
    ours, theirs = tmp_path / "port.sam", tmp_path / "jax.sam"
    assert cli.main(["dtw", *common, "--device", "cpu", "-o", str(ours)]) == 0
    assert jcli.dtw_main([*common, "--engine", "native", "-o", str(theirs)]) == 0
    text = ours.read_text()
    assert text == theirs.read_text()
    assert text.startswith(f"@SQ\tSN:synth_{N_BASES}\tLN:")
    assert "\n@PG\tID:sigfish\tPN:sigfish\tVN:" in text
    assert text.endswith(port_runs["sam"][0])


@pytest.mark.parametrize("argv", [
    ["--rna", "-p", "-1", "--invert"],
    ["--rna", "-p", "-1", "--from-end"],
    ["--pore", "rna004", "-p", "-1", "--from-end"],
    ["-p", "-1"],
    ["--dtw-std"],
    ["--invert"],
    ["--full-ref"],
])
def test_cli_cross_flag_errors_match_jax(argv, capsys, tmp_path):
    """The port's dtw parser refuses the JAX CLI's flag combinations with
    its message and exit code (argparse's, 2), before any file is read."""
    from sigfish_tpu import cli as jcli
    from sigfish_tpu_torch import cli

    args = [str(tmp_path / "ref.fa"), str(tmp_path / "reads.blow5"), *argv]
    codes, msgs = [], []
    for main in (cli.dtw_main, jcli.dtw_main):
        with pytest.raises(SystemExit) as e:
            main(args)
        codes.append(e.value.code)
        msgs.append(capsys.readouterr().err.strip().splitlines()[-1].split("error: ", 1)[1])
    assert codes == [2, 2]
    assert msgs[0] == msgs[1]
