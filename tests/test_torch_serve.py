"""The port's serving path (``models.ssm.ssm_block_decode``,
``models.layers.attn_decode`` and cross-attention, ``models.model``'s
caches, encoder-decoder forward, ``prefill`` and ``decode_step``,
``convert.decode_cache``, ``launch/serve.py``) against the reference's.

The same numpy inputs go through the reference and the port; parameters
are the reference's ``init_params`` carried across by
``convert.lm_params``, caches by ``convert.decode_cache``.  Every family
the port runs is covered at SMOKE size: the dense qwen1.5 (QKV bias), the
ssm mamba2, the moe llama4 scout and maverick, the hybrid jamba, the vlm
qwen2-vl (M-RoPE, stub patches) and the encoder-decoder whisper (stub
frames).

Tolerances (``hold``): float32 within 1e-4 of the largest magnitude, as
``tests/test_torch_models.py``'s; bf16 by each side's distance from the
port's float64 evaluation of the same inputs (a bf16 MoE stack pinned to
its float64 run's routing, ``layers.Routes``), held on two statistics:
the root-mean-square distance, the port's at most ``BF16_MULTIPLE``
(1.25) times the reference's, and the largest, at most
``BF16_MAX_MULTIPLE`` (2) times.  Over one token a sequence (a decode
step, a prefill's last logits, a cache's new row) both statistics of two
equally accurate bf16 roundings are noisy: with ``B = 2`` five cases
missed 1.25 on the largest distance, either side the closer one by
chance.  So the batch holds 8 sequences and the decode steps' logits are
held together (ROADMAP Queue C, "bf16 serving statistics"; ``-s`` prints
every distance).  The reference's jitted prefill and decode are shared by
every case of a config and dtype (``ref_runs``).
"""

import dataclasses
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as RARCH_IDS
from repro.configs import get_config as rget_config
from repro.launch import serve as rserve
from repro.models import layers as RL
from repro.models import model as RM
from repro.models import ssm as RS
from repro.models.params import init_params as rinit_params
from repro.sharding.rules import ShardingPolicy as RPolicy
from repro_torch import configs, convert
from repro_torch.core import graphs
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import ssm as S
from repro_torch.models.params import init_params
from repro_torch.sharding import ShardingPolicy


def _port_tests(name):
    """Another test file of the port, for its helpers."""
    path = Path(__file__).resolve().parent / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_{name}_serve_helpers", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TM = _port_tests("test_torch_models")
_inputs, _cfgs = TM._inputs, TM._cfgs
#: bf16: the port's largest distance from float64 at most this multiple of
#: the reference's (``chip_smoke.LM_BF16_MULTIPLE``, the card against the
#: CPU), or within ``BF16_FLOOR`` of the largest magnitude.
BF16_MAX_MULTIPLE = 2.0

ARCHS = ["qwen1_5_0_5b", "mamba2_370m", "llama4_scout_17b_16e", "llama4_maverick_400b_a17b",
         "jamba_1_5_large_398b", "qwen2_vl_7b", "whisper_base"]
DTYPES = ["float32", "bfloat16"]
B, LEN, CACHE = 8, 20, 24  # 8 prompts of 20 tokens (qwen2-vl's 16 patches and text) in 24 slots
POL, RPOL = ShardingPolicy(remat=False), RPolicy(remat=False)

to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)

R_PREFILL = jax.jit(lambda p, b, cfg, n: RM.prefill(p, cfg, b, RPOL, cache_len=n),
                    static_argnums=(2, 3))
R_DECODE = jax.jit(lambda p, c, t, cfg: RM.decode_step(p, cfg, c, t, RPOL), static_argnums=3)
R_FORWARD = jax.jit(lambda p, b, cfg: RM.forward(p, cfg, b, RPOL)[0], static_argnums=2)
R_ATTN_DECODE = jax.jit(
    lambda bp, x, kc, vc, pos, cfg, prefix, window, cross: RL.attn_decode(
        RL.pick_attn(bp, prefix), x, cfg, kc, vc, pos, window=window, cross=cross),
    static_argnums=(5, 6, 7, 8))
R_SSM_DECODE = jax.jit(lambda bp, x, conv, state, cfg: RS.ssm_block_decode(
    RS.pick_ssm(bp, ""), x, cfg, RS.SsmCache(conv, state)), static_argnums=4)


@pytest.fixture(scope="module")
def models():
    """Each config's reference parameters (key 0) in each dtype, and their
    port: {(arch, dtype): (rcfg, cfg, rparams, params)}."""
    out = {}
    for arch in ARCHS:
        rp32 = rinit_params(jax.random.PRNGKey(0), _cfgs(arch, "float32")[0])
        for dtype in DTYPES:
            rcfg, cfg = _cfgs(arch, dtype)
            rp = jax.tree_util.tree_map(lambda a: a.astype(TM.JNP_DTYPES[dtype]), rp32)
            out[arch, dtype] = (rcfg, cfg, rp, convert.lm_params(to_np(rp), "cpu"))
    return out


def _f64(cfg, p):
    return dataclasses.replace(cfg, dtype="float64"), {k: v.double() for k, v in p.items()}


def _batch(cfg, dtype, length=LEN, seed=70):
    """The reference's and the port's batch: tokens; qwen2-vl's stub
    patches and (t, h, w) positions (a 4 x 4 grid, then the text);
    whisper's stub frames.  The float inputs in ``dtype``."""
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, length))
    rb, pb = {"tokens": jnp.asarray(toks, jnp.int32)}, {"tokens": torch.from_numpy(toks)}
    if cfg.arch_type == "vlm":
        rb["patches"], pb["patches"] = _inputs((B, cfg.n_patches, cfg.d_model), dtype, seed + 1,
                                               0.02)
        grid = np.stack([np.zeros(16), np.arange(16) // 4, np.arange(16) % 4], axis=-1)
        text = np.arange(16, length)[:, None] - 12 + np.zeros(3)
        pos = np.broadcast_to(np.concatenate([grid, text])[None], (B, length, 3)).astype(np.int64)
        rb["positions"], pb["positions"] = jnp.asarray(pos, jnp.int32), torch.from_numpy(pos)
    if cfg.arch_type == "encdec":
        rb["frames"], pb["frames"] = _inputs((B, cfg.enc_seq, cfg.d_model), dtype, seed + 2, 0.1)
    return rb, pb


def hold(got, want, truth, dtype, what):
    """The port's ``got`` against the reference's ``want``, each measured
    against ``truth`` (the port's float64 evaluation): float32 by
    ``test_torch_models.hold`` (within 1e-4 of the largest magnitude);
    bf16 by the root-mean-square distance as a share of the truth's, the
    port's at most ``BF16_MULTIPLE`` times the reference's (or within
    ``BF16_FLOOR``), and by the largest as a share of max|truth|, at most
    ``BF16_MAX_MULTIPLE`` times (or within ``BF16_FLOOR``)."""
    if dtype == "float32":
        return TM.hold(got, want, truth, dtype, what)
    got, want, truth = (np.asarray(a, np.float64) for a in (got, want, truth))
    assert got.shape == want.shape == truth.shape, (got.shape, want.shape, truth.shape)
    rms = lambda a: np.sqrt(np.mean(np.square(a)))
    typical, scale = rms(truth), np.abs(truth).max()
    r_port, r_ref = rms(got - truth) / typical, rms(want - truth) / typical
    m_port, m_ref = np.abs(got - truth).max() / scale, np.abs(want - truth).max() / scale
    print(f"{what}: from float64, root-mean-square port {r_port:.3e}, reference {r_ref:.3e} "
          f"(shares of {typical:.3e}); largest port {m_port:.3e}, reference {m_ref:.3e} "
          f"(shares of {scale:.3e})")
    assert r_port <= max(TM.BF16_MULTIPLE * r_ref, TM.BF16_FLOOR), (what, r_port, r_ref)
    assert m_port <= max(BF16_MAX_MULTIPLE * m_ref, TM.BF16_FLOOR), (what, m_port, m_ref)


def _wide_batch(batch):
    return {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}


def _leaves(cache):
    """A cache's tensors by name (``pos`` apart)."""
    return {"attn.k": cache.attn.k, "attn.v": cache.attn.v, "ssm.conv": cache.ssm.conv,
            "ssm.state": cache.ssm.state, "cross.k": cache.cross.k, "cross.v": cache.cross.v}


def _hold_cache(got, want, truth, dtype, what):
    """Every leaf of the port's cache against the reference's (numpy) and
    the float64 truth; the positions equal."""
    want = convert.decode_cache(want, "cpu")
    assert int(got.pos) == int(want.pos) == int(truth.pos) and got.pos.dtype == torch.int64
    for name, t in _leaves(got).items():
        w, tr = _leaves(want)[name], _leaves(truth)[name]
        assert t.shape == w.shape and t.dtype == w.dtype, (what, name, t.shape, w.shape)
        if t.numel():
            hold(t.double(), w.double().numpy(), tr.double(), dtype, f"{what} {name}")


@pytest.fixture(scope="module")
def ref_runs(models):
    """The reference's prefill (cache 24 slots) of ``_batch`` and two decode
    steps, each from its own previous cache, per (arch, dtype), computed
    once: (logits, cache, [(token, logits, cache)] ...) as numpy."""
    memo = {}

    def run(arch, dtype):
        if (arch, dtype) not in memo:
            rcfg, cfg, rp, _ = models[arch, dtype]
            rb, _ = _batch(cfg, dtype)
            logits, cache = R_PREFILL(rp, rb, rcfg, CACHE)
            steps, c = [], cache
            for i in range(2):
                tok = np.random.default_rng(80 + i).integers(0, cfg.vocab_size, (B, 1))
                lg, c2 = R_DECODE(rp, c, jnp.asarray(tok, jnp.int32), rcfg)
                steps.append((tok, to_np(c), np.asarray(lg), to_np(c2)))
                c = c2
            memo[arch, dtype] = (np.asarray(logits), to_np(cache), steps)
        return memo[arch, dtype]

    return run


# -- layers --------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssm_block_decode_matches_reference(dtype, models):
    """mamba2's first block, one token on a random cache (conv inputs in the
    dtype, a float32 state): the delta and the new cache; the port's decode
    continues its full-sequence recurrence (the reference's
    ``test_decode_step_continues_recurrence``): 9 tokens decoded from a
    zero cache end where ``ssm_block_train`` ends, and a cache filled by
    ``ssm_block_full`` over 8 tokens decodes the 9th to the same delta."""
    rcfg, cfg, rp, p = models["mamba2_370m", dtype]
    rbp = {k: v[0] for k, v in RM._block_params(rp).items()}
    bp = {k: v[0] for k, v in M._block_params(p).items()}
    c64, p64 = _f64(cfg, p)
    bp64 = {k: v[0] for k, v in M._block_params(p64).items()}
    x, xt = _inputs((B, 1, cfg.d_model), dtype, 90)
    conv, convt = _inputs((B, cfg.ssm_conv - 1, cfg.ssm_conv_channels), dtype, 91)
    state, statet = _inputs((B, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state), "float32", 92,
                            0.3)
    want, wc = R_SSM_DECODE(rbp, x, conv, state, rcfg)
    cache = S.SsmCache(convt.clone(), statet.clone())
    got, gc = S.ssm_block_decode(S.pick_ssm(bp, ""), xt, cfg, cache)
    assert gc.conv is cache.conv and gc.state is cache.state  # in place
    assert gc.conv.dtype == cfg.torch_dtype and gc.state.dtype == torch.float32
    truth, tc = S.ssm_block_decode(S.pick_ssm(bp64, ""), xt.double(), c64,
                                   S.SsmCache(convt.double(), statet.double()))
    hold(got.double(), want, truth, dtype, f"ssm_block_decode {dtype}")
    hold(gc.conv.double(), wc.conv, tc.conv, dtype, f"ssm_block_decode conv {dtype}")
    hold(gc.state.double(), wc.state, tc.state, dtype, f"ssm_block_decode state {dtype}")

    if dtype == "float32":
        seq, seqt = _inputs((1, 9, cfg.d_model), dtype, 93, 0.1)
        sp = S.pick_ssm(bp, "")
        full = S.ssm_block_train(sp, seqt, cfg)
        cache = S.init_ssm_cache(cfg, 1, device="cpu")
        for t in range(9):
            y, cache = S.ssm_block_decode(sp, seqt[:, t:t + 1], cfg, cache)
        torch.testing.assert_close(y[:, 0], full[:, -1], atol=2e-4, rtol=1e-3)
        _, filled = S.ssm_block_full(sp, seqt[:, :8], cfg)
        y2, _ = S.ssm_block_decode(sp, seqt[:, 8:], cfg, filled)
        torch.testing.assert_close(y2[:, 0], full[:, -1], atol=2e-4, rtol=1e-3)


#: attn_decode's cases: (arch, prefix, window, cross).
ATTN_CASES = [("qwen1_5_0_5b", "attn.", 0, False), ("qwen1_5_0_5b", "attn.", 5, False),
              ("qwen2_vl_7b", "attn.", 0, False), ("whisper_base", "self.", 0, False),
              ("whisper_base", "cross.", 0, True)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pos", [0, 7, 15, 16], ids=["first", "mid", "last", "clamped"])
def test_attn_decode_matches_reference(pos, dtype, models):
    """One token a sequence against random (8, 16) K/V caches at ``pos`` (16 = S: the
    write clamped to the last slot, the mask not): qwen1.5 (QKV bias, RoPE)
    without and with a window of 5, qwen2-vl (M-RoPE at ``pos`` in all
    three components), whisper's self-attention (no RoPE) and its
    cross-attention (every key, nothing written).  The delta and both
    caches, written in place."""
    for arch, prefix, window, cross in ATTN_CASES:
        rcfg, cfg, rp, p = models[arch, dtype]
        rbp = {k: v[0] for k, v in RM._block_params(rp).items()}
        bp = {k: v[0] for k, v in M._block_params(p).items()}
        c64, p64 = _f64(cfg, p)
        bp64 = {k: v[0] for k, v in M._block_params(p64).items()}
        x, xt = _inputs((B, 1, cfg.d_model), dtype, 100)
        kshape = (B, 16, cfg.n_kv_heads, cfg.resolved_head_dim)
        (k, kt), (v, vt) = _inputs(kshape, dtype, 101), _inputs(kshape, dtype, 102)
        want, wk, wv = R_ATTN_DECODE(rbp, x, k, v, jnp.int32(pos), rcfg, prefix, window, cross)
        at = torch.tensor(pos)
        kc, vc = kt.clone(), vt.clone()
        got, gk, gv = L.attn_decode(L.pick_attn(bp, prefix), xt, cfg, kc, vc, at,
                                    window=window, cross=cross)
        assert gk is kc and gv is vc
        truth, tk, tv = L.attn_decode(L.pick_attn(bp64, prefix), xt.double(), c64,
                                      kt.double(), vt.double(), at, window=window, cross=cross)
        what = f"attn_decode {arch} {prefix}{'cross' if cross else f'w{window}'} pos {pos} {dtype}"
        hold(got.double(), want, truth, dtype, what)
        hold(gk.double(), wk, tk, dtype, what + " k")
        hold(gv.double(), wv, tv, dtype, what + " v")
        if cross:
            assert torch.equal(gk, kt) and torch.equal(gv, vt)
        else:
            assert torch.equal(gk[:, torch.arange(16) != min(pos, 15)],
                               kt[:, torch.arange(16) != min(pos, 15)])


# -- the encoder-decoder forward ------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_encdec_forward_matches_reference(dtype, models):
    """whisper's forward with stub frames (8, 64, d): the encoder
    (bidirectional blocks, ``enc_pos``, ``enc_norm``), the decoder's
    learned positions, causal self-attention and cross-attention; aux 0.
    Without frames it raises naming the reference's gap, with them
    ``check_ported`` passes."""
    rcfg, cfg, rp, p = models["whisper_base", dtype]
    rb, pb = _batch(cfg, dtype)
    want = R_FORWARD(rp, rb, rcfg)
    logits, aux = M.forward(p, cfg, pb, POL)
    assert logits.shape == (B, LEN, cfg.vocab_size) and logits.dtype == cfg.torch_dtype
    assert float(aux) == 0.0
    c64, p64 = _f64(cfg, p)
    truth, _ = M.forward(p64, c64, _wide_batch(pb), POL)
    hold(logits.double(), want, truth, dtype, f"encdec forward {dtype}")
    M.check_ported(cfg, pb)
    with pytest.raises(NotImplementedError, match="reference's gap"):
        M.check_ported(cfg, {"tokens": pb["tokens"]})
    with pytest.raises(NotImplementedError, match="reference's gap"):
        M.check_ported(cfg)


# -- caches, prefill, decode ----------------------------------------------------


@pytest.mark.parametrize("arch", RARCH_IDS)
def test_init_cache_matches_reference_layout(arch):
    """``init_cache`` of every SMOKE config: the reference's leaves, shapes
    and dtypes (size-0 where unused, a float32 state), zeros, and ``pos``
    a 0-d int64 zero."""
    cfg = configs.get_config(arch, "smoke")
    want = jax.eval_shape(lambda: RM.init_cache(rget_config(arch, "smoke"), 3, 16))
    got = M.init_cache(cfg, 3, 16, device="cpu")
    want_leaves = {"attn.k": want.attn.k, "attn.v": want.attn.v, "ssm.conv": want.ssm.conv,
                   "ssm.state": want.ssm.state, "cross.k": want.cross.k,
                   "cross.v": want.cross.v}
    for name, t in _leaves(got).items():
        w = want_leaves[name]
        assert tuple(t.shape) == w.shape, (name, t.shape, w.shape)
        assert str(t.dtype).split(".")[1] == str(w.dtype), (name, t.dtype, w.dtype)
        assert not bool(t.any())
    assert got.pos.shape == () and got.pos.dtype == torch.int64 and int(got.pos) == 0
    assert M.cache_bytes(got) == sum(t.numel() * t.element_size() for t in _leaves(got).values()) + 8


def _routes64(cfg, dtype):
    """A fresh ``Routes`` for the float64 run where a bf16 MoE stack is
    pinned to it, else None."""
    return L.Routes() if cfg.is_moe_mlp and dtype == "bfloat16" else None


def _pin(routes64):
    return None if routes64 is None else L.Routes(pin=routes64)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch, dtype, models, ref_runs):
    """``prefill`` of 8 prompts of 20 tokens into 24 slots: the last
    token's logits and every cache leaf (K after RoPE and V zero-padded,
    the conv tails and SSD final states, the cross K/V) against the
    reference's, ``pos`` 20; a bf16 MoE stack pinned to its float64 run's
    routing."""
    rcfg, cfg, rp, p = models[arch, dtype]
    rlogits, rcache, _ = ref_runs(arch, dtype)
    _, pb = _batch(cfg, dtype)
    c64, p64 = _f64(cfg, p)
    routes64 = _routes64(cfg, dtype)
    truth, tcache = M.prefill(p64, c64, _wide_batch(pb), POL, cache_len=CACHE, routes=routes64)
    logits, cache = M.prefill(p, cfg, pb, POL, cache_len=CACHE, routes=_pin(routes64))
    assert logits.shape == (B, cfg.vocab_size) and logits.dtype == cfg.torch_dtype
    hold(logits.double(), rlogits, truth, dtype, f"prefill {arch} {dtype}")
    _hold_cache(cache, rcache, tcache, dtype, f"prefill {arch} {dtype}")
    if cache.attn.k.numel():
        assert not bool(cache.attn.k[:, :, LEN:].any())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch, dtype, models, ref_runs):
    """Two ``decode_step`` calls, each from the reference's own cache
    (``convert.decode_cache``, every leaf bit for bit): every cache leaf
    after each step, ``pos`` advanced, the cache updated in place; the two
    steps' logits (16 token rows) held together; MoE layers route the 8
    tokens as one group, a bf16 stack pinned to its float64 run's
    routing."""
    rcfg, cfg, rp, p = models[arch, dtype]
    c64, p64 = _f64(cfg, p)
    logits = []
    for i, (tok, rc, rlogits, rc2) in enumerate(ref_runs(arch, dtype)[2]):
        cache = convert.decode_cache(rc, "cpu")
        for name, t in _leaves(cache).items():
            want = np.asarray(_leaves(rc)[name])
            assert t.dtype == convert.tensor(want, "cpu").dtype
            np.testing.assert_array_equal(t.float().numpy(), want.astype(np.float32))
        wide = M.DecodeCache(*(type(c)(*(t.double() for t in c)) for c in cache[:3]),
                             cache.pos.clone())
        routes64 = _routes64(cfg, dtype)
        truth, tcache = M.decode_step(p64, c64, wide, torch.from_numpy(tok), POL, routes=routes64)
        leaves = _leaves(cache)
        got, out = M.decode_step(p, cfg, cache, torch.from_numpy(tok), POL, routes=_pin(routes64))
        assert out is cache and all(a is b for a, b in zip(_leaves(out).values(),
                                                             leaves.values()))
        _hold_cache(out, rc2, tcache, dtype, f"decode {arch} {dtype} step {i}")
        assert int(out.pos) == LEN + i + 1
        logits.append((got.double(), rlogits, truth))
    hold(*(np.concatenate([np.asarray(step[j]) for step in logits]) for j in range(3)), dtype,
         f"decode {arch} {dtype} logits")


#: The reference's decode-versus-forward bounds (``tests/test_models.py``).
DECODE_TOL = {"qwen1_5_0_5b": 1e-2, "llama4_scout_17b_16e": 1e-5, "qwen2_vl_7b": 1e-5,
              "mamba2_370m": 0.05, "whisper_base": 0.02, "jamba_1_5_large_398b": 0.08,
              "llama4_maverick_400b_a17b": 1e-5}


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The reference's property on the port: on its own bf16 parameters,
    ``decode_step`` at position L (after ``prefill`` of L = 48 tokens into
    56 slots) equals ``forward``'s logits at L within the reference's
    per-family bound (maverick, which the reference's list lacks, at its
    MoE siblings' 1e-5); MoE capacity 8.0, so no token drops."""
    cfg = configs.get_config(arch, "smoke")
    if cfg.is_moe_mlp:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=8.0)
    p = init_params(0, cfg, "cpu")
    length = 48
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (B, length + 1)))
    extra = {}
    if cfg.arch_type == "encdec":
        extra["frames"] = 0.1 * torch.from_numpy(np.random.default_rng(2).standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    full, _ = M.forward(p, cfg, {"tokens": toks, **extra}, POL)
    _, cache = M.prefill(p, cfg, {"tokens": toks[:, :length], **extra}, POL,
                         cache_len=length + 8)
    dec, _ = M.decode_step(p, cfg, cache, toks[:, length:], POL)
    scale = full.float().abs().max().item() + 1e-6
    err = (dec.float() - full[:, length].float()).abs().max().item()
    print(f"decode vs forward {arch}: {err / scale:.3e} of {scale:.3e} (bound "
          f"{DECODE_TOL[arch]})")
    assert err / scale < DECODE_TOL[arch], (err, scale)


# -- generation -----------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference(arch, models):
    """Greedy ``generate`` (temperature 0, 4 tokens, float32) against the
    reference's: the tokens equal up to the first step whose float64
    top-1/top-2 logit margin lies within float32 rounding (1e-4 of the
    largest magnitude), and the logits of each step (decoded along the
    reference's tokens) within 1e-4 of the reference's up to it."""
    rcfg, cfg, rp, p = models[arch, "float32"]
    rb, pb = _batch(cfg, "float32")
    gen = 4
    rtoks, _ = rserve.generate(rcfg, rp, rb, RPOL, gen, LEN + gen + 1, 0.0,
                               jax.random.PRNGKey(0))
    rtoks = np.array(rtoks)
    toks, cache = serve.generate(cfg, p, pb, POL, gen)
    assert toks.shape == (B, gen) and toks.dtype == torch.int64
    assert int(cache.pos) == LEN + gen
    if cfg.arch_type != "ssm":
        assert cache.attn.k.shape[2] == LEN + gen + 1
    # each step's logits along the reference's tokens: reference, port, float64
    c64, p64 = _f64(cfg, p)
    rlog, rc = R_PREFILL(rp, rb, rcfg, LEN + gen + 1)
    logits, pc = M.prefill(p, cfg, pb, POL, cache_len=LEN + gen + 1)
    l64, c64_cache = M.prefill(p64, c64, _wide_batch(pb), POL, cache_len=LEN + gen + 1)
    tied = gen
    for i in range(gen):
        scale = l64.abs().max().item()
        top = l64.topk(2, dim=-1).values
        if tied == gen and bool((top[:, 0] - top[:, 1] <= 1e-4 * scale).any()):
            tied = i
        if i <= tied:
            hold(logits.double(), np.asarray(rlog), l64, "float32", f"generate {arch} step {i}")
        if i + 1 < gen:
            t = rtoks[:, i:i + 1].copy()
            rlog, rc = R_DECODE(rp, rc, jnp.asarray(t, jnp.int32), rcfg)
            logits, pc = M.decode_step(p, cfg, pc, torch.from_numpy(t), POL)
            l64, c64_cache = M.decode_step(p64, c64, c64_cache, torch.from_numpy(t), POL)
    print(f"generate {arch}: reference {rtoks.tolist()}, port {toks.tolist()}, first "
          f"near-tied step {tied}")
    np.testing.assert_array_equal(toks[:, :tied].numpy(), rtoks[:, :tied])
    # the tokens decoded are the greedy ones of the port's own logits
    np.testing.assert_array_equal(
        toks[:, :1].numpy(), M.prefill(p, cfg, pb, POL)[0].argmax(-1, keepdim=True).numpy())


def test_serve_prefill_respects_temperature(monkeypatch):
    """The counterpart of the reference's regression: the FIRST generated
    token is sampled from the prefill logits by the same rule as every
    decode step (once hard-wired to the argmax); at temperature 0 it is the
    argmax; ``sample_token`` itself: the argmax (first maximal index) at 0,
    the Gumbel-max draw from the generator's uniforms above it, whose
    frequencies are the softmax of logits / T."""
    prefill_logits = torch.tensor([[2.0, 1.8, 1.6, 1.4], [1.0, 2.0, 1.7, 1.5]])
    decode_logits = torch.zeros((2, 4)).index_fill_(1, torch.tensor([3]), 5.0)
    monkeypatch.setattr(serve, "prefill",
                        lambda p, cfg, b, policy, cache_len: (prefill_logits, None))
    monkeypatch.setattr(serve, "decode_step", lambda p, cfg, c, t, policy: (decode_logits, c))
    batch = {"tokens": torch.zeros((2, 3), dtype=torch.int64)}
    temp = 2.0
    for seed in range(64):
        expect = serve.sample_token(prefill_logits, temp, torch.Generator().manual_seed(seed))
        if not torch.equal(expect, prefill_logits.argmax(-1, keepdim=True)):
            break
    else:  # pragma: no cover - 64 straight argmax draws is ~impossible
        pytest.fail("no differing seed found")
    out, _ = serve.generate(None, None, batch, None, gen_len=3, cache_len=8,
                            temperature=temp, generator=torch.Generator().manual_seed(seed))
    assert out.shape == (2, 3)
    assert torch.equal(out[:, :1], expect)
    out0, _ = serve.generate(None, None, batch, None, gen_len=2, cache_len=8, temperature=0.0)
    assert torch.equal(out0[:, 0], prefill_logits.argmax(-1))
    assert out0[:, 1].tolist() == [3, 3]

    tie = torch.tensor([[1.0, 3.0, 3.0, 0.0]])
    assert serve.sample_token(tie, 0.0).tolist() == [[1]]
    g = torch.Generator().manual_seed(7)
    u = torch.rand((2, 4), generator=torch.Generator().manual_seed(7))
    want = (prefill_logits / temp - torch.log(-torch.log(u))).argmax(-1, keepdim=True)
    assert torch.equal(serve.sample_token(prefill_logits, temp, g), want)
    many = serve.sample_token(prefill_logits[:1].expand(20000, 4), temp,
                              torch.Generator().manual_seed(3))
    freq = torch.bincount(many[:, 0], minlength=4).double() / 20000
    torch.testing.assert_close(freq, torch.softmax(prefill_logits[0].double() / temp, -1),
                               atol=0.015, rtol=0)


SERVE_CLI = r"""
import contextlib, io, sys
from repro_torch.launch import serve
for arch in sys.argv[2:]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(["--device", "cpu", "--arch", arch, *sys.argv[1].split()])
    print(f"=== {arch}\n{out.getvalue()}", end="")
"""


@pytest.fixture(scope="module")
def cli_runs():
    """``python -m repro_torch.launch.serve --device cpu`` (2 prompts of 20
    tokens, qwen2-vl's 16 patches among them, 4 generated; qwen1.5 also at temperature 0.7) on every family,
    in one child Python on one thread: {arch: stdout}."""
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [src, os.environ.get("PYTHONPATH")])))
    names = [a.replace("_", "-") for a in ARCHS]
    runs = {}
    for flags, archs in (("--batch-size 2 --prompt-len 20 --gen-len 4", names),
                         ("--batch-size 2 --prompt-len 20 --gen-len 4 --temperature 0.7 --seed 3",
                          ["qwen1.5-0.5b"])):
        res = subprocess.run([sys.executable, "-c", SERVE_CLI, flags, *archs], env=env,
                             capture_output=True, text=True, timeout=600)
        assert res.returncode == 0, res.stderr[-4000:]
        for block in res.stdout.split("=== ")[1:]:
            arch, body = block.split("\n", 1)
            runs[arch if "temperature" not in flags else arch + " T=0.7"] = body
    return runs


@pytest.mark.parametrize("arch", [a.replace("_", "-") for a in ARCHS] + ["qwen1.5-0.5b T=0.7"])
def test_serve_cli(arch, cli_runs):
    """The reference's two lines: ``generated (2, 4) tokens in ...s (...
    tok/s incl. compile)`` and the first sequence, 4 token ids of the
    vocabulary."""
    lines = cli_runs[arch].splitlines()
    assert len(lines) == 2, lines
    assert lines[0].startswith("generated (2, 4) tokens in ") and "tok/s incl. compile)" in lines[0]
    assert lines[1].startswith("first sequence: [")
    seq = [int(t) for t in lines[1].split("[")[1].rstrip("]").split(",")]
    vocab = configs.get_config(arch.split()[0], "smoke").vocab_size
    assert len(seq) == 4 and all(0 <= t < vocab for t in seq)


def test_serve_cli_flags():
    """The reference's flags and defaults, plus ``--device``; ``--arch``
    takes the reference's ids and the published names."""
    args = serve.parser().parse_args([])
    assert (args.arch, args.variant, args.batch_size, args.prompt_len, args.gen_len,
            args.temperature, args.seed, args.device) == ("qwen1_5_0_5b", "smoke", 4, 32, 16,
                                                          0.0, 0, "cuda")
    for arch in ("qwen1.5-0.5b", "whisper-base", "jamba_1_5_large_398b"):
        assert serve.parser().parse_args(["--arch", arch]).arch == arch
    with pytest.raises(SystemExit):
        serve.parser().parse_args(["--arch", "gpt2"])
