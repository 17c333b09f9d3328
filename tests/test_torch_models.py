"""The port's model zoo (``repro_torch.models``, ``repro_torch.configs``,
``repro_torch.sharding``) against the reference's, module by module and
for the whole forward and loss.

The same numpy inputs go through the reference's function and the port's;
parameters are the reference's ``init_params`` carried across by
``convert.lm_params``.  Every module runs on the SMOKE configs of the
families the port runs: the dense qwen1.5 (QKV bias), gemma (geglu), yi
and minitron (GQA: 2 KV heads for 4 query heads), the ssm mamba2, the moe
llama4 scout and maverick (top-1 of 4 experts and a shared expert), the
hybrid jamba (one super-block: attention and 3 Mamba2 layers, each with a
top-2 MoE MLP) and the vlm qwen2-vl (M-RoPE, stub patches).

Tolerances (``hold``): the float32 variant of a config
(``dataclasses.replace(cfg, dtype="float32")``) within 1e-4 of the largest
magnitude (DESIGN.md Sec. 2.4); bf16 (the published dtype) by each side's
distance from the port's float64 evaluation of the same inputs, printed,
the port's no more than ``BF16_MULTIPLE`` times the reference's (or
within ``BF16_FLOOR`` of the largest magnitude, half a bf16 spacing).  A
bf16 stack of MoE layers is held so with its routing pinned to its
float64 run's experts (``layers.Routes``), every token compared; its own
routing differs from the float64 run's only at near-ties
(``layers.flip_margins`` within ``layers.NEAR_TIE``; ROADMAP Queue C,
"bf16 MoE stacks at near-ties").
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as RARCH_IDS
from repro.configs import all_configs as rall_configs
from repro.configs import get_config as rget_config
from repro.models import layers as RL
from repro.models import model as RM
from repro.models import ssm as RS
from repro.models.params import count_params as rcount_params
from repro.models.params import init_params as rinit_params
from repro.models.params import param_defs as rparam_defs
from repro.sharding.rules import ShardingPolicy as RPolicy
from repro_torch import configs, convert
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import ssm as S
from repro_torch.models.params import count_params, init_params, param_defs, param_shapes
from repro_torch.sharding import ShardingPolicy

#: bf16: the port no further from float64 than this multiple of the
#: reference's distance (measured on these inputs where it is above the
#: floor: at most 1.12, the forward's logits)...
BF16_MULTIPLE = 1.25
#: ... or within this share of the largest magnitude: half of bf16's
#: relative spacing (2^-8), the rounding of one bf16 number.  The loss and
#: the LM objective's values are means of token NLLs whose bf16 errors
#: partly cancel, by chance on either side (the bf16 loss: port 1.1e-4,
#: reference 1.2e-6 on mamba2), so they are held by this floor.
BF16_FLOOR = 2.0 ** -9

DENSE = ["qwen1_5_0_5b", "gemma_7b", "yi_34b", "minitron_8b"]
ALL = DENSE + ["mamba2_370m"]
MOE = ["llama4_scout_17b_16e", "llama4_maverick_400b_a17b", "jamba_1_5_large_398b"]
NEW = MOE + ["qwen2_vl_7b"]  # the moe, hybrid and vlm families
DTYPES = ["float32", "bfloat16"]

to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
JNP_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


# The reference's functions jitted once, their static arguments by
# position, so cases with the same shapes share a compile.
R_RMSNORM = jax.jit(RL.rmsnorm, static_argnums=2)
R_ROPE = jax.jit(RL.apply_rope, static_argnums=(2, 3))
R_CORE = jax.jit(RL.attention_core, static_argnums=4)
R_CHUNKED = jax.jit(RL.attention_chunked, static_argnames=("causal", "window", "chunk"))
R_ATTN = jax.jit(lambda bp, x, pos, cfg, chunk: RL.attn_block(RL.pick_attn(bp, "attn."), x, cfg,
                                                              pos, chunk=chunk),
                 static_argnums=(3, 4))
R_MLP = jax.jit(lambda bp, x, cfg: RL.mlp_block(bp, "mlp.", x, cfg), static_argnums=2)
R_SSD = jax.jit(RS.ssd_scan, static_argnums=0)
R_SSM = jax.jit(lambda bp, x, cfg: RS.ssm_block_train(RS.pick_ssm(bp, ""), x, cfg),
                static_argnums=2)
R_FORWARD = jax.jit(lambda p, b, cfg, pol: (RM.forward(p, cfg, b, pol),
                                            RM.lm_loss(p, cfg, b, pol)), static_argnums=(2, 3))
R_MROPE = jax.jit(RL.apply_rope, static_argnums=(2, 3, 4))
R_MOE = jax.jit(lambda bp, x, cfg: RL.moe_block(bp, "mlp.", x, cfg, return_aux=True),
                static_argnums=2)
R_BLOCK = jax.jit(lambda bp, x, pos, cfg: RM._full_block(bp, x, cfg, pos, RPolicy(remat=False),
                                                         cfg.sliding_window),
                  static_argnums=3)


def hold(got, want, truth, dtype, what, witness=None):
    """The port's ``got`` against the reference's ``want``, both measured
    against ``truth`` (the port's float64 evaluation), each distance as a
    share of max|truth|: float32 within 1e-4 of the reference; bf16 by
    ``BF16_MULTIPLE`` / ``BF16_FLOOR``, the reference's distance the larger
    of ``want``'s and, where given, ``witness``'s (a second evaluation of
    the reference: op by op, outside ``jax.jit``)."""
    got, want, truth = (np.asarray(a, np.float64) for a in (got, want, truth))
    assert got.shape == want.shape == truth.shape, (got.shape, want.shape, truth.shape)
    scale = np.abs(truth).max()
    gap = np.abs(got - want).max() / scale
    e_port, e_ref = np.abs(got - truth).max() / scale, np.abs(want - truth).max() / scale
    second = ""
    if witness is not None:
        e_op = np.abs(np.asarray(witness, np.float64) - truth).max() / scale
        second, e_ref = f", op by op {e_op:.3e}", max(e_ref, e_op)
    print(f"{what}: |port - reference| {gap:.3e}; from float64: port {e_port:.3e}, "
          f"reference {np.abs(want - truth).max() / scale:.3e}{second} (shares of "
          f"max|float64| {scale:.3e})")
    if dtype in (torch.float32, "float32"):
        assert gap <= 1e-4, (what, gap)
    else:
        assert e_port <= max(BF16_MULTIPLE * e_ref, BF16_FLOOR), (what, e_port, e_ref)


def near_ties_only(run, routes64, length, what):
    """``run(routes)``, a bf16 MoE call, routes its tokens as its float64 run
    (``routes64``) does but at near-ties: each first changed choice at a
    float64 margin within ``L.NEAR_TIE`` (the largest printed)."""
    routes = L.Routes()
    run(routes)
    margins = L.flip_margins(routes, routes64, length)
    top = float(margins.max()) if margins.numel() else 0.0
    print(f"{what}: {margins.numel()} tokens first routed otherwise than in float64, the "
          f"largest float64 margin among them {top:.6f}")
    assert top <= L.NEAR_TIE, (what, top)


def _cfgs(arch, dtype):
    rcfg = dataclasses.replace(rget_config(arch, "smoke"), dtype=dtype)
    cfg = dataclasses.replace(configs.get_config(arch, "smoke"), dtype=dtype)
    return rcfg, cfg


def _inputs(shape, dtype, seed, scale=1.0):
    """numpy float32 normals, rounded to ``dtype``: (numpy in the dtype,
    the port's tensor in the dtype)."""
    a = (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)
    if dtype == "bfloat16":
        a = a.astype(ml_dtypes.bfloat16)
    return a, convert.tensor(a, "cpu")


@pytest.fixture(scope="module")
def models():
    """Each SMOKE config's reference parameters (its ``init_params``, key 0)
    in each dtype, and their port."""
    out = {}
    for arch in ALL + NEW:
        rp32 = rinit_params(jax.random.PRNGKey(0), _cfgs(arch, "float32")[0])
        for dtype in DTYPES:
            rcfg, cfg = _cfgs(arch, dtype)
            # the reference draws every leaf in float32 and casts it to the
            # dtype, so its bf16 leaves are its float32 ones cast
            rp = jax.tree_util.tree_map(lambda a: a.astype(JNP_DTYPES[dtype]), rp32)
            out[arch, dtype] = (rcfg, cfg, rp, convert.lm_params(to_np(rp), "cpu"))
    return out


# -- configs, params, policy ---------------------------------------------------


def test_configs_match_reference():
    """Every FULL and SMOKE config of the ten is the reference's, field for
    field, with the same derived sizes and analytic counts; the ids and the
    dtype map."""
    assert configs.ARCH_IDS == RARCH_IDS
    for variant in ("full", "smoke"):
        for arch, rcfg in rall_configs(variant).items():
            cfg = configs.get_config(arch.replace("_", "-"), variant)
            assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg), (arch, variant)
            for prop in ("resolved_head_dim", "q_dim", "kv_dim", "ssm_inner", "ssm_heads",
                         "ssm_conv_channels", "ssm_in_proj_dim", "is_moe_mlp", "block_kind"):
                assert getattr(cfg, prop) == getattr(rcfg, prop), (arch, prop)
            if rcfg.arch_type != "hybrid" or rcfg.n_layers % rcfg.attn_every == 0:
                assert cfg.n_blocks == rcfg.n_blocks
            assert cfg.param_count() == rcfg.param_count()
            assert cfg.active_param_count() == rcfg.active_param_count()
            assert count_params(cfg) == rcount_params(rcfg)
    qwen = configs.get_config("qwen1.5-0.5b")
    assert qwen.torch_dtype == torch.bfloat16 and count_params(qwen) == 463_987_712
    assert dataclasses.replace(qwen, dtype="float32").torch_dtype == torch.float32
    assert dataclasses.replace(qwen, dtype="float64").torch_dtype == torch.float64
    with pytest.raises(ValueError, match="unsupported dtype"):
        _ = dataclasses.replace(qwen, dtype="float16").torch_dtype
    with pytest.raises(ValueError, match="bad arch_type"):
        dataclasses.replace(qwen, arch_type="rnn")
    with pytest.raises(ValueError, match="unknown variant"):
        configs.get_config("qwen1_5_0_5b", "tiny")


def test_policy_matches_reference():
    """``ShardingPolicy``'s fields and defaults are the reference's."""
    assert dataclasses.asdict(ShardingPolicy()) == dataclasses.asdict(RPolicy())
    assert ShardingPolicy(remat=False).attn_chunk == 2048


@pytest.mark.parametrize("variant", ["full", "smoke"])
def test_param_table_matches_reference(variant):
    """The declaration table of every config (every family, encoder and
    hybrid leaves included): the same names, shapes, axes and init kinds."""
    for arch, rcfg in rall_configs(variant).items():
        want = {n: (pd.shape, pd.axes, pd.init) for n, pd in rparam_defs(rcfg).items()}
        got = {n: (pd.shape, pd.axes, pd.init)
               for n, pd in param_defs(configs.get_config(arch, variant)).items()}
        assert got == want, arch


@pytest.mark.parametrize("arch", ALL + NEW)
def test_init_params(arch):
    """``init_params``: the reference's names, shapes and dtype; ones and
    zeros where it has them; normal and fan-in leaves with the reference's
    scale (std within 10%); a_log in log[1, 16], dt_bias the softplus
    inverse of [1e-3, 1e-1]; the same seed gives the same bits, leaf i from
    the generator of (seed, 2, i), also with ``device_draws``."""
    cfg = configs.get_config(arch, "smoke")
    p = init_params(3, cfg, "cpu")
    want = {k: pd.shape for k, pd in rparam_defs(rget_config(arch, "smoke")).items()}
    assert {k: tuple(v.shape) for k, v in p.items()} == want
    assert param_shapes(cfg) == {k: (tuple(v.shape), torch.bfloat16) for k, v in p.items()}
    defs = param_defs(cfg)
    for name, t in p.items():
        assert t.dtype == torch.bfloat16 and not t.requires_grad
        kind, f = defs[name].init, t.float()
        if kind in ("ones", "zeros"):
            assert bool((f == (1.0 if kind == "ones" else 0.0)).all()), name
        elif kind in ("normal", "fan_in"):
            want = 0.02 if kind == "normal" else 1.0 / np.sqrt(defs[name].shape[-2])
            assert abs(float(f.std()) / want - 1) < 0.1, name
        elif kind == "a_log":
            assert float(f.min()) >= 0.0 and float(f.max()) <= np.log(16.0) + 1e-2
        else:
            sp = torch.nn.functional.softplus(f)
            assert float(sp.min()) >= 1e-3 * 0.95 and float(sp.max()) <= 0.1 * 1.05
    again = init_params(3, cfg, "cpu")
    assert all(torch.equal(p[k], again[k]) for k in p)
    # drawn on the device given, here the CPU: the same generators, the same bits
    drawn = init_params(3, cfg, "cpu", device_draws=True)
    assert all(torch.equal(p[k], drawn[k]) for k in p)
    assert not torch.equal(init_params(4, cfg, "cpu")["embed"], p["embed"])
    f32 = init_params(3, dataclasses.replace(cfg, dtype="float32"), "cpu")
    assert all(torch.equal(f32[k].to(torch.bfloat16), p[k]) for k in p)


def test_tensor_carries_bf16_bit_for_bit():
    """``convert.tensor`` of a numpy bfloat16 array (``ml_dtypes``, which
    ``torch.from_numpy`` refuses) is a ``torch.bfloat16`` tensor with the
    same bits, NaN, infinities, subnormals and -0 included; a JAX bf16
    array likewise; other dtypes as before."""
    raw = np.random.default_rng(0).integers(0, 2 ** 16, 4096, dtype=np.uint32).astype(np.uint16)
    raw[:6] = [0x7FC0, 0x7F80, 0xFF80, 0x0001, 0x8000, 0x3F80]
    a = raw.view(ml_dtypes.bfloat16).reshape(64, 64)
    t = convert.tensor(a, "cpu")
    assert t.dtype == torch.bfloat16 and t.shape == (64, 64)
    np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16).ravel(), raw)
    j = jnp.linspace(-3, 3, 77, dtype=jnp.bfloat16)
    np.testing.assert_array_equal(convert.tensor(np.asarray(j), "cpu").float().numpy(),
                                  np.asarray(j, np.float32))
    assert convert.tensor(np.arange(3, dtype=np.int32), "cpu").dtype == torch.int32
    assert convert.tensor(np.ones(2, np.float32), "cpu").dtype == torch.float32


def test_lm_params_carry_every_leaf(models):
    """``convert.lm_params``: every leaf under its name, bit for bit, bf16
    as bf16."""
    for (arch, dtype), (_, _, rp, p) in models.items():
        assert set(p) == set(rp)
        for name, t in p.items():
            want = np.asarray(rp[name])
            assert t.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
            np.testing.assert_array_equal(t.float().numpy(), want.astype(np.float32))


# -- layers --------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ALL)
def test_rmsnorm_matches_reference(arch, dtype, models):
    """The first block's norm scale (made non-trivial) on a (2, 16, d) batch."""
    rcfg, cfg, _, _ = models[arch, dtype]
    x, xt = _inputs((2, 16, cfg.d_model), dtype, 1, scale=3.0)
    s, st = _inputs((cfg.d_model,), dtype, 2, scale=0.5)
    want = R_RMSNORM(x, s, rcfg.norm_eps)
    got = L.rmsnorm(xt, st, cfg.norm_eps)
    assert got.dtype == xt.dtype
    truth = L.rmsnorm(xt.double(), st.double(), cfg.norm_eps)
    hold(got.double(), want, truth, dtype, f"rmsnorm {arch} {dtype}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ALL)
def test_rope_matches_reference(arch, dtype, models):
    """RoPE of (2, 16, H, hd) heads at positions 0..15 and 100..115 (a
    rotation of the two halves; mamba2's mode ``none`` is the identity)."""
    rcfg, cfg, _, _ = models[arch, dtype]
    heads, hd = max(cfg.n_heads, 2), cfg.resolved_head_dim if cfg.n_heads else 32
    x, xt = _inputs((2, 16, heads, hd), dtype, 3)
    pos = np.stack([np.arange(16), np.arange(100, 116)])
    want = R_ROPE(x, pos, rcfg.rope_theta, rcfg.rope_mode)
    got = L.apply_rope(xt, torch.from_numpy(pos), cfg.rope_theta, cfg.rope_mode)
    truth = L.apply_rope(xt.double(), torch.from_numpy(pos), cfg.rope_theta, cfg.rope_mode)
    hold(got.double(), want, truth, dtype, f"rope {arch} {dtype}")
    if cfg.rope_mode == "none":
        assert got is xt


@pytest.mark.parametrize("dtype", DTYPES)
def test_mrope_matches_reference(dtype, models):
    """M-RoPE (qwen2-vl's sections (4, 6, 6) of 16 slots) of (2, 16, H, hd)
    heads at distinct (t, h, w) triples; with equal triples it is the
    standard mode bit for bit."""
    rcfg, cfg, _, _ = models["qwen2_vl_7b", dtype]
    x, xt = _inputs((2, 16, cfg.n_heads, cfg.resolved_head_dim), dtype, 4)
    rng = np.random.default_rng(5)
    pos = np.stack([np.arange(16)[None].repeat(2, 0) + 3,
                    rng.integers(0, 8, (2, 16)), rng.integers(0, 8, (2, 16)) + 40], axis=-1)
    want = R_MROPE(x, pos, rcfg.rope_theta, "mrope", rcfg.mrope_sections)
    args = (cfg.rope_theta, "mrope", cfg.mrope_sections)
    got = L.apply_rope(xt, torch.from_numpy(pos), *args)
    truth = L.apply_rope(xt.double(), torch.from_numpy(pos), *args)
    assert got.dtype == xt.dtype
    hold(got.double(), want, truth, dtype, f"mrope {dtype}")
    same = torch.from_numpy(pos[..., 1])
    torch.testing.assert_close(L.apply_rope(xt, same[..., None].expand(2, 16, 3), *args),
                               L.apply_rope(xt, same, cfg.rope_theta, "standard"),
                               rtol=0, atol=0)


@pytest.mark.parametrize("causal, window, offset", [(True, 0, 0), (False, 0, 0), (True, 5, 0),
                                                    (False, 3, 0), (True, 4, 7)])
def test_attn_mask_matches_reference(causal, window, offset):
    """Causal and window masks, a query offset, and a kv validity mask:
    the same booleans."""
    valid = np.arange(24) % 5 != 0
    for kv_valid in (None, valid):
        want = RL._attn_mask(12, 24, causal=causal, window=window, q_offset=offset,
                             kv_valid=None if kv_valid is None else jnp.asarray(kv_valid))
        got = L._attn_mask(12, 24, causal=causal, window=window, q_offset=offset,
                           kv_valid=None if kv_valid is None else torch.from_numpy(kv_valid))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("rep", [1, 2, 4])
def test_repeat_kv_is_repeat_interleave(rep):
    """``jnp.repeat`` along the head axis: each KV head repeated for its
    group in turn (head h reads KV head h // rep)."""
    k = np.random.default_rng(0).standard_normal((2, 5, 3, 4)).astype(np.float32)
    want = RL._repeat_kv(jnp.asarray(k), 3 * rep)
    got = L._repeat_kv(torch.from_numpy(k), 3 * rep)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy()[:, :, -1], k[:, :, -1])


def _qkv(cfg, dtype, length, seed):
    shapes = [(2, length, cfg.n_heads, cfg.resolved_head_dim),
              (2, length, cfg.n_kv_heads, cfg.resolved_head_dim),
              (2, length, cfg.n_kv_heads, cfg.resolved_head_dim)]
    return [_inputs(s, dtype, seed + i) for i, s in enumerate(shapes)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", DENSE)
def test_attention_core_matches_reference(arch, dtype, models):
    """Causal attention of (2, 16) queries with the config's heads (GQA
    for yi and minitron), and with a window of 5 and a softcap of 30."""
    rcfg, cfg, _, _ = models[arch, dtype]
    (q, qt), (k, kt), (v, vt) = _qkv(cfg, dtype, 16, 10)
    for window, softcap in ((0, 0.0), (5, 30.0)):
        rmask = RL._attn_mask(16, 16, causal=True, window=window)
        mask = L._attn_mask(16, 16, causal=True, window=window)
        want = R_CORE(q, k, v, rmask, softcap)
        got = L.attention_core(qt, kt, vt, mask, softcap)
        truth = L.attention_core(qt.double(), kt.double(), vt.double(), mask, softcap)
        hold(got.double(), want, truth, dtype, f"attention_core {arch} {dtype} w{window}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", DENSE)
def test_attention_chunked_matches_reference(arch, dtype, models):
    """Query-chunked attention at L = 2 * chunk (chunk 8) and 4 * chunk,
    causal and with a window; also against the port's own unchunked
    attention on the same inputs."""
    rcfg, cfg, _, _ = models[arch, dtype]
    for length, window in ((16, 0), (32, 11)):
        (q, qt), (k, kt), (v, vt) = _qkv(cfg, dtype, length, 20)
        want = R_CHUNKED(q, k, v, causal=True, window=window, chunk=8)
        got = L.attention_chunked(qt, kt, vt, causal=True, window=window, chunk=8)
        truth = L.attention_chunked(qt.double(), kt.double(), vt.double(), causal=True,
                                    window=window, chunk=8)
        hold(got.double(), want, truth, dtype, f"attention_chunked {arch} {dtype} L{length}")
        whole = L.attention_core(qt, kt, vt, L._attn_mask(length, length, causal=True,
                                                          window=window))
        torch.testing.assert_close(got, whole, rtol=0, atol=1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", DENSE)
def test_attn_block_and_mlp_block_match_reference(arch, dtype, models):
    """The first block's attention (QKV bias for qwen1.5) and gated MLP
    (geglu for gemma, swiglu otherwise) on a (2, 16, d) residual stream;
    the attention also query-chunked (``attn_chunk`` 8)."""
    rcfg, cfg, rp, p = models[arch, dtype]
    rbp = {k: v[0] for k, v in RM._block_params(rp).items()}
    bp = {k: v[0] for k, v in M._block_params(p).items()}
    bp64 = {k: v.double() for k, v in bp.items()}
    x, xt = _inputs((2, 16, cfg.d_model), dtype, 30)
    pos = np.tile(np.arange(16), (2, 1))
    for chunk in (0, 8):
        want = R_ATTN(rbp, x, pos, rcfg, chunk)
        got = L.attn_block(L.pick_attn(bp, "attn."), xt, cfg, torch.from_numpy(pos), chunk=chunk)
        truth = L.attn_block(L.pick_attn(bp64, "attn."), xt.double(), cfg,
                             torch.from_numpy(pos), chunk=chunk)
        hold(got.double(), want, truth, dtype, f"attn_block {arch} {dtype} chunk {chunk}")
    want = R_MLP(rbp, x, rcfg)
    got = L.mlp_block(bp, "mlp.", xt, cfg)
    truth = L.mlp_block(bp64, "mlp.", xt.double(), cfg)
    hold(got.double(), want, truth, dtype, f"mlp_block {arch} {cfg.mlp_act} {dtype}")


# -- ssm -----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("length, chunk, groups", [(29, 8, 1), (32, 8, 1), (40, 16, 2),
                                                   (32, 32, 1)],
                         ids=["4_chunks_padded", "4_chunks", "3_chunks_2_groups", "one_chunk"])
def test_ssd_scan_matches_reference(length, chunk, groups, dtype):
    """The chunked SSD with the inter-chunk recurrence running (3 and 4
    chunks, a sequence padded to a chunk multiple, B and C in 2 groups of
    4 heads), its outputs in the input dtype and its final state, also
    from a given initial state."""
    rcfg = dataclasses.replace(rget_config("mamba2_370m", "smoke"), ssm_chunk=chunk)
    cfg = dataclasses.replace(configs.get_config("mamba2_370m", "smoke"), ssm_chunk=chunk)
    h, p, n = 8, 8, 16
    rng = np.random.default_rng(40)
    x, xt = _inputs((2, length, h, p), dtype, 41)
    dt = np.log1p(np.exp(rng.standard_normal((2, length, h)) - 1.0)).astype(np.float32)
    a = (-np.exp(rng.uniform(-1.0, 1.0, h))).astype(np.float32)
    b, bt = _inputs((2, length, groups, n), dtype, 42)
    c, ct = _inputs((2, length, groups, n), dtype, 43)
    h0 = rng.standard_normal((2, h, p, n)).astype(np.float32)
    T = torch.from_numpy
    for init in (None, h0):
        ry, rh = R_SSD(rcfg, x, dt, a, b, c, init)
        y, hf = S.ssd_scan(cfg, xt, T(dt), T(a), bt, ct, None if init is None else T(init))
        y64, h64 = S.ssd_scan(cfg, xt.double(), T(dt).double(), T(a).double(), bt.double(),
                              ct.double(), None if init is None else T(init).double())
        assert y.dtype == xt.dtype and hf.dtype == torch.float32
        assert y.shape == (2, length, h, p) and hf.shape == (2, h, p, n)
        hold(y.double(), ry, y64, dtype, f"ssd_scan y L{length} chunk {chunk} {dtype}")
        hold(hf.double(), rh, h64, "float32", f"ssd_scan state L{length} chunk {chunk} {dtype}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("chunk", [32, 8])
def test_ssm_block_train_matches_reference(chunk, dtype, models):
    """The first Mamba2 block on a (2, 29, d) residual stream, with the
    SMOKE chunk (one chunk) and chunks of 8 (the recurrence running)."""
    rcfg, cfg, rp, p = models["mamba2_370m", dtype]
    rcfg = dataclasses.replace(rcfg, ssm_chunk=chunk)
    cfg = dataclasses.replace(cfg, ssm_chunk=chunk)
    rbp = {k: v[0] for k, v in RM._block_params(rp).items()}
    bp = {k: v[0] for k, v in M._block_params(p).items()}
    x, xt = _inputs((2, 29, cfg.d_model), dtype, 50)
    want = R_SSM(rbp, x, rcfg)
    got = S.ssm_block_train(S.pick_ssm(bp, ""), xt, cfg)
    truth = S.ssm_block_train(S.pick_ssm({k: v.double() for k, v in bp.items()}, ""),
                              xt.double(), cfg)
    assert got.dtype == xt.dtype
    hold(got.double(), want, truth, dtype, f"ssm_block_train chunk {chunk} {dtype}")


# -- moe and the hybrid super-block ---------------------------------------------


def _ref_routing(rbp, x, rcfg):
    """The reference's routing, its moe_block's lines
    (src/repro/models/layers.py:351-372) on the block's inputs: (expert
    indices (t, k), keep (t*k,)) as numpy."""
    xt = RL.rmsnorm(jnp.asarray(x), rbp["mlp.ln"], rcfg.norm_eps).reshape(-1, rcfg.d_model)
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ rbp["mlp.router"].astype(jnp.float32), -1)
    _, idx = jax.lax.top_k(probs, rcfg.moe_top_k)
    t, k, e = xt.shape[0], rcfg.moe_top_k, rcfg.n_experts
    capacity = int(max(rcfg.moe_capacity_factor * t * k / e, 4))
    capacity = min(capacity + (-capacity) % 4, t * k)
    onehot = jax.nn.one_hot(idx.reshape(-1), e, dtype=jnp.int32)
    rank = (jnp.cumsum(onehot, axis=0) - onehot)[jnp.arange(t * k), idx.reshape(-1)]
    return np.asarray(idx), np.asarray(rank < capacity)


def _moe_params(models, arch, dtype, skew):
    """The first MoE layer's parameters (jamba's: the super-block's first
    MLP) on both sides; with ``skew`` the router's column 0 is moved along
    ``skew`` (the tokens' shared direction), so most tokens pick expert 0
    and overflow its capacity."""
    rcfg, cfg, rp, p = models[arch, dtype]
    pick = (lambda v: v[0][0]) if rcfg.arch_type == "hybrid" else (lambda v: v[0])
    rbp = {k: pick(v) for k, v in RM._block_params(rp).items() if k.startswith("mlp.")}
    if skew is not None:
        router = np.asarray(rbp["mlp.router"], np.float32).copy()
        router[:, 0] += skew
        rbp["mlp.router"] = jnp.asarray(router).astype(rbp["mlp.router"].dtype)
    bp = convert.lm_params(to_np(rbp), "cpu")
    return rcfg, cfg, rbp, bp


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", MOE)
def test_moe_block_matches_reference(arch, dtype, models):
    """The first MoE layer (top-1 and a shared expert for the llama4 pair;
    top-2 for jamba) on a (2, 16, d) residual stream: its output and the
    Switch aux, and the routing (each token's experts and the kept slots)
    equal to the reference's."""
    rcfg, cfg, rbp, bp = _moe_params(models, arch, dtype, None)
    x, xt = _inputs((2, 16, cfg.d_model), dtype, 70)
    want, raux = R_MOE(rbp, x, rcfg)
    got, aux = L.moe_block(bp, "mlp.", xt, cfg)
    bp64 = {k: v.double() for k, v in bp.items()}
    truth, aux64 = L.moe_block(bp64, "mlp.", xt.double(), cfg)
    assert got.dtype == xt.dtype and aux.shape == (1,) and aux.dtype == torch.float32
    hold(got.double(), want, truth, dtype, f"moe_block {arch} {dtype}")
    hold(aux.double(), np.asarray(raux)[None], aux64, "float32", f"moe aux {arch} {dtype}")
    idx, keep = _ref_routing(rbp, x, rcfg)
    r = L.moe_route(bp["mlp.router"], L.rmsnorm(xt, bp["mlp.ln"], cfg.norm_eps).reshape(
        1, 32, cfg.d_model), cfg)
    np.testing.assert_array_equal(r.expert[0].numpy(), idx)
    np.testing.assert_array_equal(r.keep[0].numpy(), keep)


@pytest.mark.parametrize("arch", ["llama4_scout_17b_16e", "jamba_1_5_large_398b"])
def test_moe_drops_and_groups_match_reference(arch, models):
    """A skewed router (float32): most tokens pick expert 0, whose queue
    overflows its capacity, so slots are dropped; the experts, the drop
    mask, the output and the aux are the reference's.  Split into two
    groups (one sequence each), each group is routed, dropped and balanced
    as the reference's block on that sequence alone."""
    rcfg, cfg, _, _ = models[arch, "float32"]
    x, xt = _inputs((2, 16, cfg.d_model), "float32", 71)
    shared = np.random.default_rng(72).standard_normal(cfg.d_model).astype(np.float32)
    x = x + shared
    xt = torch.from_numpy(x)
    _, _, rbp, bp = _moe_params(models, arch, "float32", 2.0 * shared / np.sqrt(cfg.d_model))
    idx, keep = _ref_routing(rbp, x, rcfg)
    r = L.moe_route(bp["mlp.router"], L.rmsnorm(xt, bp["mlp.ln"], cfg.norm_eps).reshape(
        1, 32, cfg.d_model), cfg)
    np.testing.assert_array_equal(r.expert[0].numpy(), idx)
    np.testing.assert_array_equal(r.keep[0].numpy(), keep)
    assert 0 < (~keep).sum() and (idx[:, 0] == 0).mean() > 0.5, ((~keep).sum(), idx[:, 0])
    bp64 = {k: v.double() for k, v in bp.items()}
    want, raux = R_MOE(rbp, x, rcfg)
    got, aux = L.moe_block(bp, "mlp.", xt, cfg)
    truth, aux64 = L.moe_block(bp64, "mlp.", xt.double(), cfg)
    hold(got.double(), want, truth, "float32", f"moe_block {arch} skewed")
    hold(aux.double(), np.asarray(raux)[None], aux64, "float32", f"moe aux {arch} skewed")
    got, aux = L.moe_block(bp, "mlp.", xt, cfg, groups=2)
    truth, aux64 = L.moe_block(bp64, "mlp.", xt.double(), cfg, groups=2)
    for g in range(2):
        want, raux = R_MOE(rbp, x[g:g + 1], rcfg)
        hold(got[g:g + 1].double(), want, truth[g:g + 1], "float32",
             f"moe_block {arch} skewed, group {g}")
        hold(aux[g:g + 1].double(), np.asarray(raux)[None], aux64[g:g + 1], "float32",
             f"moe aux {arch} skewed, group {g}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ["jamba_1_5_large_398b", "llama4_scout_17b_16e"])
def test_full_block_matches_reference(arch, dtype, models):
    """One block of the stack on a (2, 29, d) residual stream with its aux:
    jamba's super-block (attention, then 3 Mamba2 layers, each layer
    followed by its top-2 MoE MLP) and scout's attention and MoE; in bf16
    with the routing pinned to the float64 run's."""
    rcfg, cfg, rp, p = models[arch, dtype]
    rbp = {k: v[0] for k, v in RM._block_params(rp).items()}
    bp = {k: v[0] for k, v in M._block_params(p).items()}
    x, xt = _inputs((2, 29, cfg.d_model), dtype, 73)
    pos = np.tile(np.arange(29), (2, 1))
    (want, raux) = R_BLOCK(rbp, x, pos, rcfg)
    args = (cfg, torch.from_numpy(pos), ShardingPolicy(), cfg.sliding_window, 1)
    routes64 = L.Routes()
    truth, aux64 = M._full_block({k: v.double() for k, v in bp.items()}, xt.double(), *args,
                                 routes=routes64)
    assert len(routes64.calls) == (4 if arch.startswith("jamba") else 1)
    pin = None
    if dtype == "bfloat16":
        near_ties_only(lambda r: M._full_block(bp, xt, *args, routes=r), routes64, 29,
                       f"full block {arch} {dtype}")
        pin = L.Routes(pin=routes64)
    got, aux = M._full_block(bp, xt, *args, routes=pin)
    assert got.dtype == xt.dtype
    hold(got.double(), want, truth, dtype, f"full block {arch} {dtype}")
    hold(aux.double(), np.asarray(raux)[None], aux64, dtype, f"block aux {arch} {dtype}")


# -- forward and loss ----------------------------------------------------------


def _batch(cfg, length=32, seed=60):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, length + 1))
    labels = toks[:, 1:].copy()
    labels[1, -5:] = -1  # skipped labels
    return toks[:, :-1], labels


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ALL + NEW)
def test_forward_and_lm_loss_match_reference(arch, dtype, models):
    """The whole forward's logits (2, 32, V), its aux and ``lm_loss`` (with
    five skipped labels) on every family's SMOKE config; the dense ones in
    float32 also with ``attn_chunk`` 8 (the query-chunked attention in
    every layer).  The dense and ssm families' aux is 0."""
    rcfg, cfg, rp, p = models[arch, dtype]
    p64 = {k: v.double() for k, v in p.items()}
    c64 = dataclasses.replace(cfg, dtype="float64")
    toks, labels = _batch(cfg)
    rbatch = {"tokens": jnp.asarray(toks, jnp.int32), "labels": jnp.asarray(labels, jnp.int32)}
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    for chunk in ((2048, 8) if arch in DENSE and dtype == "float32" else (2048,)):
        rpol, pol = RPolicy(remat=False, attn_chunk=chunk), ShardingPolicy(attn_chunk=chunk)
        (rlogits, raux), (rtotal, rm) = R_FORWARD(rp, rbatch, rcfg, rpol)
        routes64 = L.Routes()
        truth, aux64 = M.forward(p64, c64, batch, pol, routes=routes64)
        pin = lambda: None
        if cfg.is_moe_mlp and dtype == "bfloat16":
            near_ties_only(lambda r: M.forward(p, cfg, batch, pol, routes=r), routes64, 32,
                           f"forward {arch} {dtype}")
            pin = lambda: L.Routes(pin=routes64)
        pinned = pin()
        logits, aux = M.forward(p, cfg, batch, pol, routes=pinned)
        assert logits.dtype == cfg.torch_dtype and logits.shape == (2, 32, cfg.vocab_size)
        if pinned is not None:  # every layer took the float64 run's experts and drops
            for r, r64 in zip(pinned.calls, routes64.calls, strict=True):
                assert torch.equal(r.expert, r64.expert) and torch.equal(r.keep, r64.keep)
        hold(logits.double(), rlogits, truth, dtype, f"forward {arch} {dtype} chunk {chunk}")
        assert aux.shape == (1,) and aux.dtype == torch.float32
        if not cfg.is_moe_mlp:
            assert float(aux) == float(raux) == 0.0
        else:
            hold(aux.double(), np.asarray(raux)[None], aux64, dtype, f"forward aux {arch} {dtype}")
        total, m = M.lm_loss(p, cfg, batch, pol, routes=pin())
        assert int(m["tokens"]) == int(rm["tokens"]) == 59
        assert total.dtype == torch.float32 and m["moe_aux"].shape == ()
        assert float(m["moe_aux"]) == float(aux)
        truth, _ = M.lm_loss(p64, c64, batch, pol)
        hold(total.double().numpy()[None], np.asarray(rtotal)[None], truth.numpy()[None],
             dtype, f"lm_loss {arch} {dtype} chunk {chunk}")


@pytest.mark.parametrize("dtype", DTYPES)
def test_vlm_forward_with_patches_matches_reference(dtype, models):
    """qwen2-vl's forward and loss on 2 sequences with stub patch embeddings
    (2, 16, d) over the first 16 positions and distinct M-RoPE (t, h, w)
    triples: the patches' rows and columns of a 4 x 4 image grid, then the
    text's positions.  bf16 has two witnesses, the reference jitted and op
    by op (``jax.disable_jit``: each op rounded to bf16, as the port's): the
    largest distance over two sequences' logits is a noisy statistic of
    equally accurate roundings (ROADMAP Queue C, "bf16 witnesses")."""
    rcfg, cfg, rp, p = models["qwen2_vl_7b", dtype]
    toks = np.random.default_rng(60).integers(0, cfg.vocab_size, (2, 33))
    toks, labels = toks[:, :-1], toks[:, 1:].copy()
    labels[1, -5:] = -1
    patches, patches_t = _inputs((2, cfg.n_patches, cfg.d_model), dtype, 61, scale=0.02)
    grid = np.stack([np.zeros(16), np.arange(16) // 4, np.arange(16) % 4], axis=-1)
    text = np.arange(16, 32)[:, None] - 12 + np.zeros(3)
    pos = np.broadcast_to(np.concatenate([grid, text])[None], (2, 32, 3)).astype(np.int64)
    rbatch = {"tokens": jnp.asarray(toks, jnp.int32), "labels": jnp.asarray(labels, jnp.int32),
              "patches": patches, "positions": jnp.asarray(pos, jnp.int32)}
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels),
             "patches": patches_t, "positions": torch.from_numpy(pos)}
    pol, rpol = ShardingPolicy(), RPolicy(remat=False)
    (rlogits, _), (rtotal, _) = R_FORWARD(rp, rbatch, rcfg, rpol)
    op_logits = op_total = None
    if dtype == "bfloat16":
        with jax.disable_jit():
            op_logits, _ = RM.forward(rp, rcfg, rbatch, rpol)
            op_total, _ = RM.lm_loss(rp, rcfg, rbatch, rpol)
            op_total = np.asarray(op_total)[None]
    logits, _ = M.forward(p, cfg, batch, pol)
    p64 = {k: v.double() for k, v in p.items()}
    c64 = dataclasses.replace(cfg, dtype="float64")
    truth, _ = M.forward(p64, c64, dict(batch, patches=patches_t.double()), pol)
    hold(logits.double(), rlogits, truth, dtype, f"vlm forward with patches {dtype}", op_logits)
    plain, _ = M.forward(p, cfg, {"tokens": batch["tokens"]}, pol)
    assert not torch.equal(plain, logits)
    total, _ = M.lm_loss(p, cfg, batch, pol)
    truth, _ = M.lm_loss(p64, c64, dict(batch, patches=patches_t.double()), pol)
    hold(total.double().numpy()[None], np.asarray(rtotal)[None], truth.numpy()[None], dtype,
         f"vlm lm_loss with patches {dtype}", op_total)


@pytest.mark.parametrize("arch, item", [("whisper_base", "reference's gap")])
def test_unported_families_raise_naming_their_item(arch, item):
    """Whisper's forward raises naming the reference's gap (its forward
    needs encoder frames)."""
    cfg = configs.get_config(arch, "smoke")
    p = init_params(0, cfg, "cpu")
    toks = torch.zeros((1, 8), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match=item):
        M.forward(p, cfg, {"tokens": toks}, ShardingPolicy())


@pytest.mark.parametrize("arch", NEW)
def test_new_families_run_on_their_own_params(arch):
    """The moe, hybrid and vlm forwards on the port's own parameters
    (``init_params``, bf16): finite logits of the batch's shape and a
    finite aux for each of 2 groups, positive for the MoE families; a
    batch that does not split into the groups raises."""
    cfg = configs.get_config(arch, "smoke")
    p = init_params(0, cfg, "cpu")
    toks = torch.arange(32, dtype=torch.int64).reshape(4, 8) * 7 % cfg.vocab_size
    logits, aux = M.forward(p, cfg, {"tokens": toks}, ShardingPolicy(), groups=2)
    assert logits.shape == (4, 8, cfg.vocab_size) and logits.dtype == torch.bfloat16
    assert bool(torch.isfinite(logits).all()) and aux.shape == (2,)
    assert bool((aux > 0).all()) if cfg.is_moe_mlp else bool((aux == 0).all())
    with pytest.raises(ValueError, match="does not split into 3 groups"):
        M.forward(p, cfg, {"tokens": toks}, ShardingPolicy(), groups=3)
