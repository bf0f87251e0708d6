"""The ragged decode kernel's split of the sequence (K4/K5), on the CPU.

Two things: the host's plan (``ops/ragged_decode_attention.split_plan``),
and a plain version of the kernel's algorithm, written here for the tests
only. It takes each row's valid slots as one list (the prompt's
[pstart, lens), then the decode columns' [dstart, slot], clamped to the
panel), gives CTA r of ``splits`` the share [n·r/splits, n·(r+1)/splits),
deals the share's 16-slot pieces to 4 warps in turn, keeps a partial
(max, sum, accumulator) per warp, merges the warps, then the CTAs in rank
order, and adds the sink once at the end. It is held against
``ragged_decode_plain`` and against JAX's Pallas kernel in interpret mode
on the same numpy inputs.

Tolerance: rtol/atol 2e-5 in f32, as tests/test_torch_attention.py: the
same masked softmax in another order of sums. A row that sees no key is 0
in the port with or without a sink; the JAX kernel without a sink writes a
finite average there (padding), so that row is held against JAX only with
sinks.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lapha_tpu.ops.ragged_decode_attention import ragged_decode_attention as j_ragged
from lapha_tpu_torch.ops import ragged_decode_attention as rda

TOL = dict(rtol=2e-5, atol=2e-5)
NEG = -1e30
PIECE, WARPS = 16, 4  # the kernel's piece of a warp and warps of a CTA
SMS = 132             # an H100 SXM's SMs

# rows: (lens, dstart, pstart) at S = 160, slot = 150
L, S, SLOT, NH, NKV, DH = 2, 160, 150, 6, 2, 32
ROWS = ((70, 128, 0),      # a prompt and the decode columns
        (77, 77, 0),       # the prompt tail and the decode start share a chunk
        (60, 140, 90),     # pstart past lens: no prompt slot
        (0, 148, 0),       # three valid slots: most splits are empty
        (0, 151, 0),       # no key at all (dstart past the slot)
        (128, 128, 5))     # a long row, clipped at its start
NO_KEY = 4


def _valid_list(lens, dstart, pstart, slot, S):
    """The kernel's list of a row's valid slots: the prompt's, then the decode
    columns', each clamped to the panel."""
    p0, d0 = max(pstart, 0), max(dstart, 0)
    n1, n2 = max(min(lens, S) - p0, 0), max(slot + 1 - d0, 0)
    return np.concatenate([p0 + np.arange(n1), d0 + np.arange(n2)]).astype(np.int64)


def _partial(s, v):
    """(m, l, acc) of logits s (n, G) over values v (n, G, dh) (the V scale
    already in v); an empty set is (NEG, 0, 0)."""
    G, dh = s.shape[1], v.shape[-1]
    if s.shape[0] == 0:
        return torch.full((G,), NEG), torch.zeros(G), torch.zeros(G, dh)
    m = s.amax(0)
    p = torch.exp(s - m)
    return m, p.sum(0), torch.einsum("ng,ngd->gd", p, v)


def _merge(parts, sink=None):
    """Merge (m, l, acc) partials in order; the sink column joins once."""
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    if sink is not None:
        M = torch.maximum(M, sink)
    w = [torch.exp(m - M) for m, _, _ in parts]
    l_ = sum(l * f for (_, l, _), f in zip(parts, w))
    acc = sum(a * f[:, None] for (_, _, a), f in zip(parts, w))
    if sink is not None:
        l_ = l_ + torch.exp(sink - M)
    return M, l_, acc


def split_merge_reference(q, kc, vc, layer, lens, dstart, slot, pstart, splits, *, scale=None,
                          cache_scale=None, sinks=None, softcap=0.0, sink_per_split=False):
    """The kernel's algorithm in f32 torch ops; same arguments and result as
    ``ragged_decode_plain`` but ``splits`` (CTAs a row). ``sink_per_split``
    plants the fault of adding the sink in every split's partial."""
    B, nh, dh = q.shape
    nkv, Sc = kc.shape[2], kc.shape[3]
    G = nh // nkv
    scale = dh ** -0.5 if scale is None else scale
    out = torch.zeros(B, nh, dh)
    for b in range(B):
        idx = _valid_list(int(lens[b]), int(dstart[b]), int(pstart[b]), slot, Sc)
        n = len(idx)
        for hk in range(nkv):
            qg = q[b, hk * G:(hk + 1) * G].float()
            k, v = kc[layer, b, hk].float(), vc[layer, b, hk].float()
            s_all = (k[idx] @ qg.T) * scale  # (n, G)
            v_all = v[idx][:, None, :].expand(n, G, dh)
            if cache_scale is not None:
                s_all = s_all * cache_scale[0][layer, b, hk][idx][:, None]
                v_all = v_all * cache_scale[1][layer, b, hk][idx][:, None, None]
            if softcap:
                s_all = softcap * torch.tanh(s_all / softcap)
            sink = None if sinks is None else sinks[hk * G:(hk + 1) * G].float()
            ctas = []
            for r in range(splits):
                lo, hi = n * r // splits, n * (r + 1) // splits
                pieces = [np.arange(lo + PIECE * j, min(lo + PIECE * (j + 1), hi))
                          for j in range((hi - lo + PIECE - 1) // PIECE)]
                warps = []
                for w in range(WARPS):
                    mine = torch.from_numpy(np.concatenate(pieces[w::WARPS] or [[]])).long()
                    warps.append(_partial(s_all[mine], v_all[mine]))
                ctas.append(_merge(warps, sink if sink_per_split else None))
            _, l_, acc = _merge(ctas, None if sink_per_split else sink)
            out[b, hk * G:(hk + 1) * G] = torch.where(l_[:, None] > 0, acc / l_[:, None],
                                                      torch.zeros(()))
    return out


def _inputs(int8, sinks, seed=7):
    rng = np.random.default_rng(seed)
    B = len(ROWS)
    q = rng.normal(size=(B, NH, DH)).astype(np.float32) * 2.0
    k = rng.normal(size=(L, B, NKV, S, DH)).astype(np.float32)
    v = rng.normal(size=(L, B, NKV, S, DH)).astype(np.float32)
    lens, dstart, pstart = (np.asarray(c, np.int32) for c in zip(*ROWS))
    scl = None
    if int8:
        ks = np.abs(k).max(-1) / 127.0
        vs = np.abs(v).max(-1) / 127.0
        k = np.round(k / ks[..., None]).astype(np.int8)
        v = np.round(v / vs[..., None]).astype(np.int8)
        scl = (ks.astype(np.float32), vs.astype(np.float32))
    sk = None
    if sinks:
        # each head's sink near its log-sum-exp over the rows that see a key,
        # so that a sink counted more than once moves the output
        kf = k.astype(np.float32) * (scl[0][..., None] if int8 else 1.0)
        lse = []
        for b, (ln, ds, ps) in enumerate(ROWS):
            idx = _valid_list(ln, ds, ps, SLOT, S)
            if len(idx):
                s = np.einsum("kgd,knd->kgn", q[b].reshape(NKV, NH // NKV, DH),
                              kf[1, b][:, idx]) * DH ** -0.5
                mx = s.max(-1, keepdims=True)
                lse.append((mx + np.log(np.exp(s - mx).sum(-1, keepdims=True)))[..., 0])
        sk = (np.mean(lse, 0).reshape(NH) + rng.normal(size=NH) * 0.3).astype(np.float32)
    return q, k, v, lens, dstart, pstart, scl, sk


def _torch(*arrs):
    return [None if a is None else torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


@functools.lru_cache(maxsize=None)
def _jax_out(int8, sinks):
    q, k, v, lens, dstart, pstart, scl, sk = _inputs(int8, sinks)
    out = j_ragged(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 1, jnp.asarray(lens),
                   jnp.asarray(dstart), jnp.asarray(SLOT, jnp.int32),
                   cache_scale=None if scl is None else (jnp.asarray(scl[0]), jnp.asarray(scl[1])),
                   pstart=jnp.asarray(pstart), sinks=None if sk is None else jnp.asarray(sk),
                   block_k=32, block_rows=4, interpret=True)
    return np.asarray(out)


def _reference_and_plain(int8, sinks, splits, softcap=0.0, sink_per_split=False):
    q, k, v, lens, dstart, pstart, scl, sk = _inputs(int8, sinks)
    tq, tk, tv, tl, td, tp, tsk = _torch(q, k, v, lens, dstart, pstart, sk)
    tscl = None if scl is None else tuple(_torch(*scl))
    ref = split_merge_reference(tq, tk, tv, 1, tl, td, SLOT, tp, splits, cache_scale=tscl,
                                sinks=tsk, softcap=softcap, sink_per_split=sink_per_split)
    plain = rda.ragged_decode_plain(tq, tk, tv, 1, tl, td, SLOT, tp, cache_scale=tscl, sinks=tsk,
                                    softcap=softcap)
    return ref.numpy(), plain.numpy()


@pytest.mark.parametrize("splits", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("int8,sinks", [(False, False), (True, False), (False, True),
                                        (True, True)])
def test_split_merge_matches_plain_and_jax(splits, int8, sinks):
    """Every split count over rows with a shared chunk, pstart past lens, a
    row of three slots (empty splits) and a row with no key, bf16-like and
    int8 caches, with and without sinks near the LSE."""
    ref, plain = _reference_and_plain(int8, sinks, splits)
    np.testing.assert_allclose(ref, plain, **TOL)
    j_out = _jax_out(int8, sinks)
    seen = np.ones(len(ROWS), bool)
    if not sinks:
        seen[NO_KEY] = False  # JAX's padding average; the port's 0 is checked below
    np.testing.assert_allclose(ref[seen], j_out[seen], **TOL)
    assert (ref[NO_KEY] == 0).all() and (plain[NO_KEY] == 0).all()


@pytest.mark.parametrize("splits", [1, 3, 8])
@pytest.mark.parametrize("int8", [False, True])
def test_split_merge_softcap_matches_plain(splits, int8):
    """The cap on the true logit (after the K scale), before the mask; the
    Pallas kernel has none, so only the plain version holds it. q is large
    enough (x2, logits of ~1-3x the cap of 2) that the cap bites: a
    reference without it must fail."""
    ref, plain = _reference_and_plain(int8, False, splits, softcap=2.0)
    np.testing.assert_allclose(ref, plain, **TOL)
    uncapped, _ = _reference_and_plain(int8, False, splits)
    assert np.abs(uncapped - plain).max() > 100 * TOL["atol"]


@pytest.mark.parametrize("splits", [2, 3, 5, 8])
@pytest.mark.parametrize("int8", [False, True])
def test_sink_counted_once_across_splits(splits, int8):
    """The sink enters once, in the final merge: a reference that adds it in
    every split's partial (the planted fault) moves far from JAX once there
    are two splits, with the sinks near the LSE."""
    j_out = _jax_out(int8, True)
    good, _ = _reference_and_plain(int8, True, splits)
    bad, _ = _reference_and_plain(int8, True, splits, sink_per_split=True)
    np.testing.assert_allclose(good, j_out, **TOL)
    assert np.abs(bad - j_out).max() > 1e3 * TOL["atol"]


# ---------------------------------------------------------------- the host's plan

SHAPES = [(B, nkv, group, max_len, dh, int8)
          for B in (1, 3, 24, 48, 96) for nkv in (1, 2, 4, 8, 32) for group in (1, 6, 12, 32)
          for max_len in (1, 17, 64, 65, 581, 4096) for dh in (64, 96, 128, 256)
          for int8 in (False, True)]


@pytest.mark.parametrize("B,nkv,group,max_len,dh,int8", SHAPES[::53])
def test_split_plan_bounds(B, nkv, group, max_len, dh, int8):
    """At most 8 splits and a power of two, never more than the row has
    64-slot chunks, no more CTAs than can be resident at once when it
    splits, 1 or 2 stages within a CTA's shared memory, and the same plan
    for the same shape."""
    plan = rda.split_plan(B, nkv, group, max_len, SMS, dh=dh, int8=int8)
    assert 1 <= plan.splits <= rda.MAX_SPLITS
    assert plan.splits <= -(-max_len // rda.CHUNK)
    assert 1 <= plan.stages <= 2
    smem = rda.cta_smem(dh, int8, group, plan.stages, plan.splits)
    assert smem <= 227 * 1024
    assert plan.splits & (plan.splits - 1) == 0  # a power of two
    ctas = B * nkv * (-(-group // 16) if group > 8 else 1)  # a CTA per 16 heads of a group
    if plan.splits > 1:
        assert ctas * plan.splits <= SMS * (rda.SMEM_PER_SM // (smem + 1024))
    assert plan == rda.split_plan(B, nkv, group, max_len, SMS, dh=dh, int8=int8)
    if ctas >= SMS:
        assert plan.splits == 1


@pytest.mark.parametrize("B,nkv,group,max_len,dh,int8,splits", [
    (24, 32, 1, 601, 96, False, 1),    # Phi-3-mini: 768 CTAs fill the card
    (24, 8, 8, 601, 64, True, 1),      # GPT-OSS: 192
    (24, 1, 4, 601, 256, False, 4),    # Gemma-3-1B: one KV head, one 133 KB CTA an SM
    (24, 4, 2, 601, 256, False, 1),    # Gemma-2-2B: 96 such CTAs already
    (24, 4, 2, 601, 256, True, 2),     # Gemma-2-2B over an int8 cache: 70 KB a CTA
    (24, 2, 6, 581, 128, False, 2),    # Qwen2.5-1.5B, chip_smoke's phase 1
    (48, 2, 6, 701, 128, True, 2),     # bench.py's int8-KV shape
    (24, 2, 12, 601, 128, False, 2),   # StarCoder2-3B
    (24, 1, 32, 601, 128, False, 2),   # a group of 32: two CTAs of 16 heads
    (24, 1, 4, 100, 128, False, 2),    # short rows: no more splits than chunks
])
def test_split_plan_at_the_served_shapes(B, nkv, group, max_len, dh, int8, splits):
    assert rda.split_plan(B, nkv, group, max_len, SMS, dh=dh, int8=int8).splits == splits


def test_split_plan_refuses_empty_shapes():
    with pytest.raises(ValueError, match="split_plan"):
        rda.split_plan(0, 2, 6, 100, SMS, dh=128, int8=False)


# ---------------------------------------------------------------- the wrapper's host path


class _FakeLib:
    """Records the C entry called and its arguments; returns cudaSuccess."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, entry):
        return lambda *args: self.calls.append((entry, args)) or 0


@pytest.mark.parametrize("int8,sinks,softcap", [(False, False, 0.0), (True, False, 0.0),
                                                (False, True, 0.0), (True, True, 0.0),
                                                (False, False, 50.0)])
def test_wrapper_passes_the_plan_to_its_entry(monkeypatch, int8, sinks, softcap):
    """The CUDA path up to the C call, on CPU tensors with the device checks
    stubbed: each of the four entries is called once, counted once under its
    name, and ends with the plan for its shape (splits, stages) and the
    stream; the lengths stay tensors (nothing is synchronised)."""
    from lapha_tpu_torch.ops import _cuda

    fake = _FakeLib()
    for stub in ("require_cuda_bf16", "require_cuda"):
        monkeypatch.setattr(_cuda, stub, lambda *a, **k: None)
    monkeypatch.setattr(_cuda, "lib", lambda: fake)
    monkeypatch.setattr(_cuda, "sm_count", lambda dev: SMS)
    monkeypatch.setattr(_cuda, "stream_of", lambda t: 7)
    B, nh, nkv, dh, S, slot = 24, 12, 2, 128, 640, 580
    q = torch.zeros(B, nh, dh, dtype=torch.bfloat16)
    kc = torch.zeros(2, B, nkv, S, dh, dtype=torch.int8 if int8 else torch.bfloat16)
    scl = (torch.ones(2, B, nkv, S), torch.ones(2, B, nkv, S)) if int8 else None
    lens = torch.full((B,), 300, dtype=torch.int32)
    name = "ragged_decode_attention" + ("_q8" if int8 else "") + ("_sink" if sinks else "")
    before = dict(_cuda.LAUNCHES)
    out = rda._ragged_cuda(q, kc, kc, 1, lens, lens, slot, None, dh ** -0.5, scl,
                           torch.zeros(nh) if sinks else None, softcap)
    assert out.shape == (B, nh, dh)
    (entry, args), = fake.calls
    assert entry == rda._ENTRIES[name]
    plan = rda.split_plan(B, nkv, nh // nkv, slot + 1, SMS, dh=dh, int8=int8)
    assert args[-3:] == (plan.splits, plan.stages, 7)
    assert args[-5:-3] == (dh ** -0.5, softcap)
    assert len(args) == 19 + 2 * int8 + int(sinks)
    counted = name + ("_softcap" if softcap else "")
    assert {k: v - before[k] for k, v in _cuda.LAUNCHES.items() if v != before[k]} == {counted: 1}
