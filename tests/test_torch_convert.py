"""State carried across from the JAX package (sigfish_tpu_torch/convert.py),
the port's copies of the host modules against their originals, and the
port's refusals: no CUDA device when one is asked for, and options of
later slices (those that earlier slices refused and this one serves now
map as the JAX package does)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sigfish_tpu import output as j_output
from sigfish_tpu.io.blow5 import Slow5File as JSlow5File
from sigfish_tpu.ops import events as j_events
from sigfish_tpu.runtime.pipeline import Core as JCore, Options as JOptions
from sigfish_tpu_torch import output as t_output
from sigfish_tpu_torch.convert import core_state_from_numpy
from sigfish_tpu_torch.io.blow5 import Slow5File, Slow5Record, Slow5Writer
from sigfish_tpu_torch.ops import events as t_events
from sigfish_tpu_torch.runtime import pipeline as tp


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A two-contig FASTA and a BLOW5 of six synthetic reads, one of
    them with an empty signal."""
    d = tmp_path_factory.mktemp("torch_convert")
    rng = np.random.default_rng(3)
    seqs = ["".join("ACGT"[b] for b in rng.integers(0, 4, n)) for n in (700, 333)]
    fa = d / "ref.fa"
    fa.write_text(f">c1 first\n{seqs[0][:350]}\n{seqs[0][350:]}\n>c2\n{seqs[1]}\n")
    bl = d / "reads.blow5"
    with Slow5Writer(str(bl), header_data=[{"experiment_type": "genomic_dna"}]) as w:
        for i in range(6):
            n = 0 if i == 5 else int(rng.integers(2000, 6000))
            steps = np.repeat(rng.normal(0, 300, size=n // 10 + 1), 10)[:n]
            sig = np.clip(steps + rng.normal(0, 40, n), -32000, 32000).astype(np.int16)
            w.write_record(Slow5Record(
                read_id=f"read{i}", read_group=0, digitisation=8192.0,
                offset=10.0, range=1400.0, sampling_rate=4000.0, raw_signal=sig,
            ))
    return str(fa), str(bl)


@pytest.mark.parametrize("query_size,ckpt", [(250, 512), (40, 64)])
def test_state_from_jax_core_equals_own(pair, query_size, ckpt):
    """core_state_from_numpy over a sigfish_tpu Core's arrays equals the
    state the port builds itself with gen_ref + pad_tracks."""
    fa, bl = pair
    j = JCore(fa, bl, JOptions(query_size=query_size, ckpt=ckpt, num_thread=1,
                               engine="native"))
    s = core_state_from_numpy(
        j.model.level_mean, j.model.level_stdv, j.kmer_size, j.ref_cat, j.reset,
        j.track_offsets, j.track_sizes, j.track_meta,
    )
    t = tp.Core(fa, bl, tp.Options(query_size=query_size, ckpt=ckpt, num_thread=1,
                                   device="cpu"))
    own = t.state
    for name in ("ref_cat", "reset", "offsets"):
        a, b = getattr(s, name), getattr(own, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert s.track_sizes == own.track_sizes and s.track_meta == own.track_meta
    assert s.model.kmer_size == own.model.kmer_size
    assert np.array_equal(s.model.level_mean, own.model.level_mean)
    assert np.array_equal(s.model.level_stdv, own.model.level_stdv)
    # a Core built from the carried state has the same output metadata
    t2 = tp.Core(fa, bl, tp.Options(query_size=query_size, ckpt=ckpt, num_thread=1,
                                    device="cpu"), state=s)
    for f in ("ref_names", "ref_lengths", "ref_seq_lengths", "ref_st_offset"):
        assert getattr(t2.ref, f) == getattr(j.ref, f) == getattr(t.ref, f), f
    for c in (j, t, t2):
        c.close()


def test_state_rejects_inconsistent_arrays():
    lm = np.zeros(4**2, np.float32)
    ref = np.zeros(64, np.float32)
    reset = np.zeros(64, bool)
    ok = dict(level_mean=lm, level_stdv=lm, kmer_size=2, ref_cat=ref, reset=reset,
              offsets=[0, 32, 64], track_sizes=[30, 30], track_meta=[(0, "+"), (0, "-")])
    core_state_from_numpy(**ok)
    for bad in (dict(kmer_size=3), dict(reset=reset[:10]), dict(offsets=[0, 64]),
                dict(track_sizes=[40, 30]), dict(offsets=[0, 32, 96])):
        with pytest.raises(ValueError):
            core_state_from_numpy(**{**ok, **bad})


def test_host_copies_match_originals(pair):
    """Decode, events, prefix events, z-score and paf_line of the port's
    copies equal the originals on synthetic reads."""
    _, bl = pair
    js, ts = JSlow5File(bl), Slow5File(bl)
    n = 0
    while True:
        jb, tb = js.read_next_blob(), ts.read_next_blob()
        assert jb == tb
        if jb is None:
            break
        jr, tr = js.decode_record(jb), ts.decode_record(tb)
        assert jr.read_id == tr.read_id
        assert np.array_equal(jr.raw_signal, tr.raw_signal)
        if tr.len_raw_signal == 0:
            continue
        pa_j, pa_t = jr.to_pa(), tr.to_pa()
        assert np.array_equal(pa_j, pa_t)
        je, te = j_events.get_events(pa_j), t_events.get_events(pa_t)
        for f in ("start", "length", "mean", "stdv"):
            assert np.array_equal(getattr(je, f), getattr(te, f)), f
        S = pa_t.size // 2
        (jp, jn), (tp_, tn) = (m.get_events_prefix(pa[:S], False, S - 100)
                               for m, pa in ((j_events, pa_j), (t_events, pa_t)))
        assert jn == tn and np.array_equal(jp.mean, tp_.mean)
        n += 1
    assert n == 5
    js.close()
    ts.close()
    args = ("read0", 4000, 500, 3100, "-", "c1", 700, 100, 349, 12.345, float("inf"), 60, 249)
    assert t_output.paf_line(*args) == j_output.paf_line(*args)
    args2 = ("r", 10, 0, 9, "+", "c", 9, 0, 8, 1.0, 1.004999, 3, 8)
    assert t_output.paf_line(*args2) == j_output.paf_line(*args2)


def test_zscore_matches_jax_pipeline(pair):
    """The port's _finish_normalise z-scores a query window exactly as
    the JAX pipeline's."""
    from sigfish_tpu.runtime import pipeline as jp

    fa, bl = pair
    j = JCore(fa, bl, JOptions(query_size=40, num_thread=1, engine="native"))
    t = tp.Core(fa, bl, tp.Options(query_size=40, num_thread=1, device="cpu"))
    blob = t.sf.read_next_blob()
    wj = jp._prepare_read(j, blob)
    wt = tp._prepare_read(t, blob)
    assert (wj.qstart, wj.qend) == (wt.qstart, wt.qend)
    assert np.array_equal(wj.query, wt.query)
    assert np.array_equal(wj.event_mean, wt.event_mean)
    j.close()
    t.close()


def test_cuda_core_without_gpu_raises(pair):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    fa, bl = pair
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.Core(fa, bl, tp.Options(device="cuda"))
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.Core(fa, bl, tp.Options())  # the default is the card


@pytest.mark.parametrize("kw", [
    dict(rna=True, pore="rna004"), dict(sam=True), dict(dtw_std=True), dict(from_end=True),
    dict(full_ref=True), dict(invert=True), dict(secondary=True), dict(pore="r10"),
    dict(mesh="2x1"), dict(host_stages="device"), dict(rna=True, full_ref=True),
])
def test_later_options_raise(pair, kw):
    """The options here were refused by earlier slices and are served
    now, --host-stages device and --mesh among them: each maps the reads
    to the JAX package's bytes (native engine, the same option; for
    --mesh its single-device run, as under a mesh the JAX Core leaves the
    native engine for its scan engine, whose prefix-min drifts by an
    ulp)."""
    import io

    from sigfish_tpu.runtime.pipeline import run_dtw as j_run_dtw

    fa, bl = pair
    core = tp.Core(fa, bl, tp.Options(device="cpu", num_thread=1, **kw))
    got = io.StringIO()
    tp.run_dtw(core, got)
    core.close()
    if "mesh" in kw:
        assert core.mesh_mode == "tracks" and core.routes["mesh_tracks"] > 0
    j = JCore(fa, bl, JOptions(num_thread=1, engine="native",
                               **{k: v for k, v in kw.items() if k != "mesh"}))
    want = io.StringIO()
    j_run_dtw(j, want)
    j.close()
    assert got.getvalue() == want.getvalue()
    assert core.total_reads == 6 and len(got.getvalue().splitlines()) >= 4
