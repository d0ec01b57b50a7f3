"""The port's out-of-core factor streaming against the JAX package and
against its own one-shot functions, on the CPU in float64 (float32 for the
fused rank-IC route), with seeded numpy inputs.

- ``streamed_factor_stats`` bitwise the port's one-shot
  ``daily_factor_stats`` for every chunk width, and the JAX package's
  streamed stats at 1e-12; serial, prefetched, device-sourced and disk
  runs bitwise equal; with ``FM_RANK_IC_FUSED=1`` (float32, 128 assets)
  through the fused kernel's plain twin, within K3's tolerance of the
  post-sort route.
- ``streamed_weighted_composite`` against the dense contraction and JAX's;
  ``streamed_linear_research`` against JAX's, and its one-pass composite
  against the port's two-pass flow.
- Chunk files written by either package read by the other, byte-equal.
- The LRU's counters equal the JAX package's over the same call sequence.
- The checkpoint: a run killed after its first chunks resumes bitwise,
  with a lineage ledger byte-equal to straight through.
- ``mesh=``/``sharding=`` in a world of one, bitwise the unsharded runs.

The pinned copy-stream path runs on the card only:
``tests/test_torch_streaming_card.py``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from factormodeling_tpu import io as jio
from factormodeling_tpu.parallel import streaming as jst
from factormodeling_tpu_torch import io as tio
from factormodeling_tpu_torch import resil
from factormodeling_tpu_torch.metrics import daily_factor_stats
from factormodeling_tpu_torch.obs.lineage import LineageLedger
from factormodeling_tpu_torch.parallel import streaming as st
from tests.torch_threads import torch_one_thread  # noqa: F401

F, D, N = 10, 48, 24
STATS = ("ic", "rank_ic", "factor_return")


def _market(seed=20261018, f=F, d=D, n=N, dtype=np.float64):
    rng = np.random.default_rng(seed)
    stack = rng.normal(size=(f, d, n)).astype(dtype)
    stack[rng.random(stack.shape) < 0.03] = np.nan
    ret = rng.normal(scale=0.02, size=(d, n)).astype(dtype)
    uni = rng.random((d, n)) > 0.1
    return stack, ret, uni


MARKET = _market()


def momentum_weights(stats_d):
    """Factorwise momentum weights of a chunk (stable identity: the cached
    per-chunk callables key on it)."""
    fr = stats_d["factor_return"]
    return fr.clip(min=0.0) if isinstance(fr, torch.Tensor) else \
        jnp.clip(fr, 0.0, None)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's streamed outputs, computed once for the module."""
    stack, ret, uni = MARKET
    out = {}
    for chunk in (3, 4):
        src, sl = jst.host_array_source(stack, chunk)
        out["stats", chunk] = {k: np.asarray(v) for k, v in
                               jst.streamed_factor_stats(
                                   src, len(sl), jnp.asarray(ret),
                                   universe=jnp.asarray(uni),
                                   shift_periods=2).items()}
    src, sl = jst.host_array_source(stack, 4)
    w = np.random.default_rng(3).random((F, D))
    out["w"] = w
    out["composite"] = np.asarray(jst.streamed_weighted_composite(
        src, [w[s] for s in sl], universe=jnp.asarray(uni)))
    out["linear"] = {k: np.asarray(v) for k, v in
                     jst.streamed_linear_research(
                         src, len(sl), jnp.asarray(ret),
                         chunk_weight_fn=momentum_weights,
                         universe=jnp.asarray(uni), shift_periods=2,
                         stats=("rank_ic", "factor_return")).items()}
    return out


def test_chunk_slices_cover_exactly():
    for f, c in ((10, 3), (10, 5), (1, 4), (7, 7)):
        sl = st.chunk_slices(f, c)
        assert sum(s.stop - s.start for s in sl) == f
        assert [(s.start, s.stop) for s in sl] == \
            [(s.start, s.stop) for s in jst.chunk_slices(f, c)]
    with pytest.raises(ValueError):
        st.chunk_slices(4, 0)


@pytest.mark.parametrize("chunk", [3, 4])
def test_streamed_stats_match_one_shot_and_jax(jax_ref, chunk):
    stack, ret, uni = MARKET
    src, sl = st.host_array_source(stack, chunk)
    got = st.streamed_factor_stats(src, len(sl), _t(ret), universe=_t(uni),
                                   shift_periods=2, device="cpu")
    one = daily_factor_stats(_t(stack), _t(ret), shift_periods=2,
                             universe=_t(uni), stats=STATS)
    for k in STATS:
        np.testing.assert_array_equal(got[k].numpy(), one[k].numpy())
        np.testing.assert_allclose(got[k].numpy(), jax_ref["stats", chunk][k],
                                   rtol=0, atol=1e-12, equal_nan=True)


def test_serial_prefetched_device_and_disk_sources_are_bitwise(tmp_path):
    stack, ret, uni = MARKET
    kw = dict(universe=_t(uni), shift_periods=2, device="cpu")
    src, sl = st.host_array_source(stack, 4)
    base = st.streamed_factor_stats(src, len(sl), _t(ret), **kw)
    pre = st.streamed_factor_stats(src, len(sl), _t(ret), prefetch=2, **kw)
    dev_stack = _t(stack)
    fused = st.streamed_factor_stats(lambda i: dev_stack[sl[i]], len(sl),
                                     _t(ret), fuse_source=True, **kw)
    tio.save_factor_stack_chunks(tmp_path / "s",
                                 (stack[s] for s in sl),
                                 factor_names=[f"f{i}" for i in range(F)])
    dsrc, dsl, man = tio.disk_chunk_source(tmp_path / "s")
    assert man["sizes"] == [4, 4, 2] and len(dsl) == 3
    disk = st.streamed_factor_stats(dsrc, len(dsl), _t(ret), prefetch=1,
                                    **kw)
    # the chunk files hold float32: the disk run equals a float32 host run
    s32, _ = st.host_array_source(stack.astype(np.float32), 4)
    host32 = st.streamed_factor_stats(s32, len(sl), _t(ret), **kw)
    for got, want in ((pre, base), (fused, base), (disk, host32)):
        for k in STATS:
            np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())


def test_chunk_files_cross_between_the_packages(tmp_path):
    stack, _, _ = MARKET
    names = [f"f{i}" for i in range(F)]
    sl = st.chunk_slices(F, 4)
    dates = np.arange(D)
    tio.save_factor_stack_chunks(tmp_path / "port", (_t(stack[s]) for s in sl),
                                 factor_names=names, dates=dates)
    jio.save_factor_stack_chunks(tmp_path / "jax", (stack[s] for s in sl),
                                 factor_names=names, dates=dates)
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "port").iterdir())
    for name in files:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()
    jsrc, jsl, jman = jio.disk_chunk_source(tmp_path / "port")
    psrc, psl, pman = tio.disk_chunk_source(tmp_path / "jax")
    assert jman == pman == json.loads(
        (tmp_path / "jax" / "manifest.json").read_text())
    for i in range(len(sl)):
        np.testing.assert_array_equal(np.asarray(jsrc(i)), psrc(i))
    with pytest.raises(ValueError, match="names given"):
        tio.save_factor_stack_chunks(tmp_path / "bad", [stack[:2]],
                                     factor_names=["a"])


def test_streamed_composite_matches_dense_and_jax(jax_ref):
    stack, _, uni = MARKET
    from factormodeling_tpu_torch import ops

    w = jax_ref["w"]
    src, sl = st.host_array_source(stack, 4)
    got = st.streamed_weighted_composite(src, [w[s] for s in sl],
                                         universe=_t(uni), prefetch=1,
                                         device="cpu")
    z = torch.nan_to_num(ops.cs_zscore(_t(stack), universe=_t(uni)))
    dense = torch.einsum("fd,fdn->dn", _t(w), z)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(got.numpy(), jax_ref["composite"], rtol=0,
                               atol=1e-12)
    for transform in ("rank", "none", lambda x: x * 2.0):
        a = st.streamed_weighted_composite(src, [w[s] for s in sl],
                                           transform=transform,
                                           universe=_t(uni), device="cpu")
        b = jst.streamed_weighted_composite(src, [w[s] for s in sl],
                                            transform=transform,
                                            universe=jnp.asarray(uni))
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12)
    with pytest.raises(ValueError, match="unknown transform"):
        st.streamed_weighted_composite(src, [w], transform="bogus",
                                       device="cpu")
    with pytest.raises(ValueError, match="empty"):
        st.streamed_weighted_composite(src, [], device="cpu")


def test_linear_research_matches_jax_and_the_two_pass_flow(jax_ref):
    stack, ret, uni = MARKET
    src, sl = st.host_array_source(stack, 4)
    stats = ("rank_ic", "factor_return")
    got = st.streamed_linear_research(src, len(sl), _t(ret),
                                      chunk_weight_fn=momentum_weights,
                                      universe=_t(uni), shift_periods=2,
                                      stats=stats, device="cpu")
    for k, v in jax_ref["linear"].items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=0, atol=1e-12,
                                   equal_nan=True)
    # the two-pass flow: stats, weights normalized per date, composite
    two = st.streamed_factor_stats(src, len(sl), _t(ret), universe=_t(uni),
                                   shift_periods=2, stats=stats,
                                   device="cpu")
    u = momentum_weights(two)
    norm = u.sum(0)
    wn = torch.where(norm > 0, u / torch.where(norm > 0, norm, 1.0), 0.0)
    comp = st.streamed_weighted_composite(src, [wn[s] for s in sl],
                                          universe=_t(uni), device="cpu")
    np.testing.assert_allclose(got["composite"].numpy(), comp.numpy(),
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got["unnormalized_weights"].numpy(),
                                  u.numpy())


def test_fused_rank_ic_route_through_the_plain_twin(monkeypatch):
    # float32 rows of 128 assets take K3's route with the switch on (its
    # plain version here), within K3's tolerance of the post-sort route
    stack, ret, uni = _market(seed=7, f=6, d=20, n=128, dtype=np.float32)
    src, sl = st.host_array_source(stack, 4)
    kw = dict(universe=_t(uni), stats=("rank_ic",), device="cpu")
    monkeypatch.delenv("FM_RANK_IC_FUSED", raising=False)
    off = st.streamed_factor_stats(src, len(sl), _t(ret), **kw)["rank_ic"]
    monkeypatch.setenv("FM_RANK_IC_FUSED", "1")
    on = st.streamed_factor_stats(src, len(sl), _t(ret), **kw)["rank_ic"]
    one = daily_factor_stats(_t(stack), _t(ret), universe=_t(uni),
                             stats=("rank_ic",))["rank_ic"]
    np.testing.assert_array_equal(on.numpy(), one.numpy())
    np.testing.assert_allclose(on.numpy(), off.numpy(), rtol=0, atol=2e-5,
                               equal_nan=True)


def test_cache_counters_equal_the_jax_packages():
    stack, ret, uni = MARKET
    dev_stack, jdev = _t(stack), jnp.asarray(stack)
    sl = st.chunk_slices(F, 5)
    src, _ = st.host_array_source(stack, 5)
    jsrc = lambda i: jax.lax.dynamic_slice_in_dim(jdev, i * 5, 5)  # noqa: E731
    psrc = lambda i: dev_stack[sl[i]]  # noqa: E731
    seqs = []
    for mod, ret_, uni_, fsrc, kw in (
            (st, _t(ret), _t(uni), psrc, {"device": "cpu"}),
            (jst, jnp.asarray(ret), jnp.asarray(uni), jsrc, {})):
        mod.clear_streaming_cache()
        seq = []
        for shift in (1, 1, 2):
            mod.streamed_factor_stats(src, 2, ret_, universe=uni_,
                                      shift_periods=shift, **kw)
            seq.append(dict(mod.streaming_cache_stats()))
        for _ in range(2):
            mod.streamed_factor_stats(fsrc, 2, ret_, universe=uni_,
                                      fuse_source=True, **kw)
            seq.append(dict(mod.streaming_cache_stats()))
        prev = mod.set_kernel_cache_size(1)
        seq.append(dict(mod.streaming_cache_stats(), prev=prev))
        mod.set_kernel_cache_size(prev)
        mod.clear_streaming_cache()
        seqs.append(seq)
    assert seqs[0] == seqs[1]
    assert seqs[0][1]["hits"] == 1 and seqs[0][-1]["evictions"] == 2
    with pytest.raises(ValueError):
        st.set_kernel_cache_size(0)


def test_checkpointed_stats_resume_bitwise_with_the_ledger(tmp_path):
    stack, ret, uni = MARKET
    src, sl = st.host_array_source(stack, 3)
    kw = dict(universe=_t(uni), shift_periods=2, device="cpu")
    straight_ledger = LineageLedger()
    straight = st.streamed_factor_stats(
        src, len(sl), _t(ret), lineage=straight_ledger,
        checkpoint=resil.Checkpointer(tmp_path / "a.ckpt"), **kw)

    def dying(i):
        if i == 2:
            raise KeyboardInterrupt("killed in chunk 2")
        return src(i)

    ck = resil.Checkpointer(tmp_path / "b.ckpt")
    with pytest.raises(KeyboardInterrupt):
        st.streamed_factor_stats(dying, len(sl), _t(ret), checkpoint=ck,
                                 lineage=LineageLedger(), **kw)
    resumed_ledger = LineageLedger()
    served = []

    def counting(i):
        served.append(i)
        return src(i)

    resumed = st.streamed_factor_stats(counting, len(sl), _t(ret),
                                       checkpoint=ck,
                                       lineage=resumed_ledger, **kw)
    # chunk 0 read once for the resume guard, then the unprocessed chunks
    assert served == [0, 2, 3]
    for k in STATS:
        np.testing.assert_array_equal(resumed[k].numpy(),
                                      straight[k].numpy())
    assert resumed_ledger.state() == straight_ledger.state()
    assert len(straight_ledger.rows("x")) == len(sl) + 1
    # other inputs: the snapshot is skipped, never resumed into this run
    fresh = st.streamed_factor_stats(src, len(sl), _t(ret * 2.0),
                                     checkpoint=ck, **kw)
    assert fresh["ic"].shape == (F, D)


def test_mesh_and_sharding_are_not_ported(tmp_path):
    """The mesh and sharding options, ported: in a ``("date",)`` world of
    one each streamed function gives bitwise its unsharded result, from
    whole chunks and from date-block sources (the multi-rank runs are in
    ``test_torch_distributed.py``)."""
    from factormodeling_tpu_torch.parallel import make_mesh, release_world

    stack, ret, _ = MARKET
    src, sl = st.host_array_source(stack, 4)
    try:
        mesh = make_mesh(("date",), device="cpu")
        sharding = st.chunk_sharding(mesh)
        assert sharding.dims == (None, "date", None)
        bsrc, bsl = st.host_array_source(stack, 4, sharding=sharding)
        assert bsl == sl
        tio.save_factor_stack_chunks(tmp_path, [stack[s] for s in sl],
                                     factor_names=[f"f{i}" for i in
                                                   range(stack.shape[0])])
        dsrc, dsl, _ = tio.disk_chunk_source(tmp_path, sharding=sharding)
        plain_disk, _, _ = tio.disk_chunk_source(tmp_path)
        kw = dict(shift_periods=2)
        for source, plain in ((src, src), (bsrc, src), (dsrc, plain_disk)):
            got = st.streamed_factor_stats(source, len(sl), _t(ret),
                                           mesh=mesh, **kw)
            want = st.streamed_factor_stats(plain, len(sl), _t(ret),
                                            device="cpu", **kw)
            for k, v in want.items():
                assert torch.equal(torch.nan_to_num(got[k], 7.0),
                                   torch.nan_to_num(v, 7.0)), k
        got = st.streamed_linear_research(
            bsrc, len(sl), _t(ret), chunk_weight_fn=momentum_weights,
            mesh=mesh)
        want = st.streamed_linear_research(
            src, len(sl), _t(ret), chunk_weight_fn=momentum_weights,
            device="cpu")
        for k, v in want.items():
            assert torch.equal(torch.nan_to_num(got[k], 7.0),
                               torch.nan_to_num(v, 7.0)), k
        w = [np.ones((s.stop - s.start, D)) for s in sl]
        assert torch.equal(
            st.streamed_weighted_composite(bsrc, w, mesh=mesh),
            st.streamed_weighted_composite(src, w, device="cpu"))
    finally:
        release_world()
