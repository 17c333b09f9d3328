"""Model-backed federated ZOO objectives, the paper's real-world tasks (port
of ``repro.core.model_objectives``).

1. Federated black-box adversarial attack (Sec. 6.2): N private classifiers
   trained on P-controlled label subsets; the ZOO input x is an image
   perturbation, the local function is client i's margin on z + x (lower is
   better; the attack succeeds when the AVERAGE margin < 0).  The victims
   train on a synthetic blob-image task, so nothing is downloaded.

2. Federated non-differentiable metric optimization (Sec. 6.3): a fully
   trained MLP is fine-tuned by perturbing its output layer to optimize
   1 - precision on each client's label subset (Covertype stand-in:
   synthetic 7-class tabular data).

3. LM-backbone objective (framework integration, DESIGN.md Sec. 5): the ZOO
   input shifts the final-norm gains of a zoo model (``repro_torch.models``;
   gains = final_norm + scale * (x - 1/2) in the model's dtype) and the
   local function is the client's own token-batch loss / 10.

The functions follow ``core/objectives.py``: the stacked objective carries
a leading client axis N on every leaf, points are (N, ..., d) with one
batch of points per client, the query noise is an argument z of shape
(N, ...), and ``*_global_value(cps, x)`` takes one point (d,) and returns ().
Every tensor a maker returns has ``requires_grad=False``, so no query
records an autograd graph (the engine's chunks are captured on the card).

The makers draw from explicit generators seeded from their ``seed``
(``algorithms.stream_seed``): the data (the LM's tokens too) from ``(seed,
0)``, the label partition from ``(seed, 1)`` and the initial parameters
from ``(seed, 2, ...)``, all on the CPU, so the card and the CPU train
from the same numbers.  Torch cannot replay the reference's threefry keys; parity with
the reference comes from carrying its trained objectives across
(``repro_torch.convert``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree

from repro_torch.core.algorithms import stream_seed
from repro_torch.core.objectives import _lead
from repro_torch.data.partition import label_subset_partition
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Routes
from repro_torch.models.model import check_ported, forward, token_nll
from repro_torch.optim.optimizers import adam_init, adam_update
from repro_torch.sharding.rules import ShardingPolicy

# ---------------------------------------------------------------------------
# shared tiny-MLP machinery (victims + metric model)
# ---------------------------------------------------------------------------


class MLPParams(NamedTuple):
    w1: torch.Tensor  # (*B, d_in, d_hidden)
    b1: torch.Tensor  # (*B, d_hidden)
    w2: torch.Tensor  # (*B, d_hidden, n_classes)
    b2: torch.Tensor  # (*B, n_classes)


def mlp_init(gen: torch.Generator, d_in: int, d_hidden: int, n_classes: int) -> MLPParams:
    """Normal weights scaled by 1/sqrt(fan-in) and zero biases, drawn from
    ``gen`` on its device."""
    dev = gen.device
    return MLPParams(
        w1=torch.randn(d_in, d_hidden, generator=gen, device=dev) / math.sqrt(d_in),
        b1=torch.zeros(d_hidden, device=dev),
        w2=torch.randn(d_hidden, n_classes, generator=gen, device=dev) / math.sqrt(d_hidden),
        b2=torch.zeros(n_classes, device=dev),
    )


def stack(params: list[MLPParams]) -> MLPParams:
    """MLPs stacked along a new leading axis."""
    return MLPParams(*(torch.stack(leaves) for leaves in zip(*params)))


def to(tree, device):
    """(Nested) named tuples of tensors, an objective or its params, moved
    to ``device``."""
    return pytree.tree_map_only(torch.Tensor, lambda t: t.to(device), tree)


def mlp_logits(p: MLPParams, x: torch.Tensor) -> torch.Tensor:
    """Logits (*B, n, C) of points x (*B, n, d_in) under params whose
    leaves carry the leading axes *B (or none: then x may have any leading
    axes)."""
    h = torch.tanh(x @ p.w1 + p.b1.unsqueeze(-2))
    return h @ p.w2 + p.b2.unsqueeze(-2)


def _train_mlp(p: MLPParams, xs: torch.Tensor, ys: torch.Tensor, steps: int = 300,
               lr: float = 5e-3, weights: Optional[torch.Tensor] = None
               ) -> tuple[MLPParams, torch.Tensor]:
    """Adam on the mean cross-entropy of (xs (*B, n, d_in), ys (*B, n)),
    every MLP of the stack (leading axes *B) on its own batch.  ``weights``
    (*B, n), each row summing to 1, takes the place of the mean where the
    batches are padded.  The loss is log-softmax times one-hot, so its
    backward has no scatter: two runs on one device give the same bits.
    Returns the trained params (detached) and each step's loss before its
    update, (steps, *B)."""
    onehot = F.one_hot(ys, p.b2.shape[-1]).to(xs.dtype)
    losses = []
    with torch.enable_grad():
        p = MLPParams(*(t.detach().clone().requires_grad_(True) for t in p))
        opt = adam_init(p)
        for _ in range(steps):
            nll = -(torch.log_softmax(mlp_logits(p, xs), dim=-1) * onehot).sum(-1)
            loss = nll.mean(-1) if weights is None else (nll * weights).sum(-1)
            grads = torch.autograd.grad(loss.sum(), p)
            with torch.no_grad():
                new, opt = adam_update(opt, MLPParams(*grads), p, lr)
            p = MLPParams(*(t.requires_grad_(True) for t in new))
            losses.append(loss.detach())
    return MLPParams(*(t.detach() for t in p)), torch.stack(losses)


# ---------------------------------------------------------------------------
# synthetic datasets
# ---------------------------------------------------------------------------


def blob_images(gen: torch.Generator, n: int, side: int = 16, n_classes: int = 10
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Class = a fixed spatial Gaussian-blob template + noise: images
    (n, side * side) and labels (n,), drawn from ``gen``."""
    dev = gen.device
    grid = torch.arange(side, dtype=torch.float32, device=dev)
    ii, jj = torch.meshgrid(grid, grid, indexing="ij")
    centers = 3.0 + (side - 6.0) * torch.rand(n_classes, 2, generator=gen, device=dev)
    widths = 2.0 + 2.0 * torch.rand(n_classes, generator=gen, device=dev)
    templates = torch.exp(
        -((ii[None] - centers[:, 0, None, None]) ** 2 + (jj[None] - centers[:, 1, None, None]) ** 2)
        / (2 * widths[:, None, None] ** 2)
    )  # (C, side, side)
    labels = torch.randint(0, n_classes, (n,), generator=gen, device=dev)
    imgs = templates[labels] + 0.3 * torch.randn(n, side, side, generator=gen, device=dev)
    return imgs.reshape(n, side * side), labels


def tabular_covertype_like(gen: torch.Generator, n: int, d: int = 54, n_classes: int = 7
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Covertype stand-in: overlapping classes hard enough that the trained
    MLP sits visibly below 100% precision (so ZOO fine-tuning has
    headroom).  Rows (n, d) and labels (n,), drawn from ``gen``."""
    dev = gen.device
    protos = torch.randn(n_classes, d, generator=gen, device=dev)
    labels = torch.randint(0, n_classes, (n,), generator=gen, device=dev)
    return protos[labels] + 3.5 * torch.randn(n, d, generator=gen, device=dev), labels


def _cpu_generator(seed: int, *words: int) -> torch.Generator:
    return torch.Generator().manual_seed(stream_seed(seed, *words))


def _client_subsets(parts, size: int, *, upto: bool) -> list[np.ndarray]:
    """Each client's draw from its indices with ``default_rng(client)``,
    with replacement where it has fewer than ``size``, as the reference's
    makers draw: ``size`` indices (the metric's evaluation rows), or with
    ``upto`` no more than the client has (the attack's training images)."""
    return [np.random.default_rng(i).choice(idx, size=min(size, len(idx)) if upto else size,
                                            replace=len(idx) < size)
            for i, idx in enumerate(parts)]


# ---------------------------------------------------------------------------
# 1) federated black-box adversarial attack (Sec. 6.2)
# ---------------------------------------------------------------------------


class AttackObjective(NamedTuple):
    """Stacked per-client victims + the target image (shared)."""

    victims: MLPParams  # leading axis N on every leaf
    z: torch.Tensor  # (N, d_img) target image, the same for every client
    label: torch.Tensor  # (N,) int64 true class, shared
    eps: torch.Tensor  # (N,) L_inf attack radius (x in [0,1] -> [-eps, eps])
    noise_std: torch.Tensor  # (N,)


def make_attack_objective(
    seed: int,
    n_clients: int = 10,
    p_shared: float = 0.5,
    side: int = 16,
    n_classes: int = 10,
    eps: float = 0.3,
    noise_std: float = 0.001,
    train_per_client: int = 512,
    device: str | torch.device = "cuda",
) -> tuple[AttackObjective, torch.Tensor]:
    """Trains N victims (hidden width 64) on P-controlled label subsets of
    4096 blob images, all N in one batched loop on ``device``; picks the
    target among the first 256 images.  Returns (objective, image)."""
    device = resolve_device(device)
    xs, ys = blob_images(_cpu_generator(seed, 0), 4096, side, n_classes)
    parts = label_subset_partition(ys.numpy(), n_clients, p_shared, seed=stream_seed(seed, 1))
    subs = _client_subsets(parts, train_per_client, upto=True)
    # Clients whose classes hold fewer than train_per_client points train on
    # fewer; their rows are padded and weighted 0.
    width = max(len(s) for s in subs)
    idx = np.zeros((n_clients, width), dtype=np.int64)
    wts = np.zeros((n_clients, width), dtype=np.float32)
    for i, s in enumerate(subs):
        idx[i, :len(s)], wts[i, :len(s)] = s, 1.0 / len(s)
    weights = None if all(len(s) == width for s in subs) else torch.from_numpy(wts).to(device)
    idx = torch.from_numpy(idx)
    p0 = stack([mlp_init(_cpu_generator(seed, 2, i), side * side, 64, n_classes)
                for i in range(n_clients)])
    victims, _ = _train_mlp(to(p0, device), xs[idx].to(device), ys[idx].to(device),
                            weights=weights)

    # target: the image with the LARGEST averaged true-class margin -- the
    # paper's success criterion is on the averaged model, and under strong
    # P-heterogeneity no single image may be known to every victim.
    head = xs[:256].to(device)
    lg = mlp_logits(victims, head.expand(n_clients, -1, -1))  # (N, 256, C)
    labels = ys[:256].to(device).expand(n_clients, -1)
    margins = torch.mean(_margin(lg, labels), dim=0)
    target = int(torch.argmax(margins))
    rep = lambda v: torch.full((n_clients,), v, dtype=torch.float32, device=device)
    obj = AttackObjective(
        victims=victims,
        z=head[target].expand(n_clients, -1).contiguous(),
        label=torch.full((n_clients,), int(ys[target]), dtype=torch.int64, device=device),
        eps=rep(eps),
        noise_std=rep(noise_std),
    )
    return obj, head[target].clone()


def _margin(lg: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logit_true - max_other logit: logits (..., C), labels (...)."""
    true = lg.gather(-1, labels[..., None])[..., 0]
    other = torch.max(lg - 1e9 * F.one_hot(labels, lg.shape[-1]).to(lg.dtype), dim=-1).values
    return true - other


def attack_margin(cps: AttackObjective, x_unit: torch.Tensor) -> torch.Tensor:
    """f_i(x) = logit_true - max_other logit on z + perturbation, at
    per-client points (N, ..., d) -> (N, ...).  < 0 == this client
    misclassifies.  x_unit in [0,1]^d -> [-eps, eps]^d."""
    n, d = cps.z.shape
    pts = x_unit.reshape(n, -1, d)
    pert = (2.0 * pts - 1.0) * cps.eps[:, None, None]
    lg = mlp_logits(cps.victims, cps.z[:, None, :] + pert)  # (N, K, C)
    margin = _margin(lg, cps.label[:, None].expand(n, pts.shape[1]))
    return (margin / 10.0).reshape(x_unit.shape[:-1])  # scale into the |f|<=1 regime of Sec. 2


def attack_query(cps: AttackObjective, x_unit: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Noisy query y = f_i(x) + sigma_i z with z ~ N(0, 1): (N, ..., d) -> (N, ...)."""
    return attack_margin(cps, x_unit) + _lead(cps.noise_std, z) * z


def attack_global_value(cps: AttackObjective, x_unit: torch.Tensor) -> torch.Tensor:
    """F(x) = mean_i f_i(x), the averaged margin, at one point x (d,) -> ()."""
    return torch.mean(attack_margin(cps, x_unit.expand(cps.z.shape[0], -1)))


def attack_success(cps: AttackObjective, x_unit: torch.Tensor) -> torch.Tensor:
    """The paper's success criterion: the AVERAGED margin misclassifies."""
    return (attack_global_value(cps, x_unit) < 0).to(torch.float32)


# ---------------------------------------------------------------------------
# 2) federated non-differentiable metric optimization (Sec. 6.3)
# ---------------------------------------------------------------------------


class MetricObjective(NamedTuple):
    base: MLPParams  # theta*, the same for every client (leading axis N)
    xs: torch.Tensor  # (N, n_eval, d_in) client eval data
    ys: torch.Tensor  # (N, n_eval) int64
    scale: torch.Tensor  # (N,) perturbation scale
    noise_std: torch.Tensor  # (N,)
    n_classes: torch.Tensor  # (N,)


def make_metric_objective(
    seed: int,
    n_clients: int = 7,
    p_shared: float = 0.7,
    n_eval: int = 256,
    scale: float = 0.25,
    noise_std: float = 0.001,
    device: str | torch.device = "cuda",
) -> tuple[MetricObjective, int]:
    """Trains the MLP (hidden width 16, 150 steps) on 4096 of 8192 tabular
    rows on ``device``; each client evaluates it on ``n_eval`` rows of its
    label subset of the other 4096.  Returns (objective, perturbation dim
    d): d = the size of the output layer (w2, b2), the fine-tuned slice."""
    device = resolve_device(device)
    xs, ys = tabular_covertype_like(_cpu_generator(seed, 0), 8192)
    p0 = mlp_init(_cpu_generator(seed, 2), xs.shape[-1], 16, 7)
    theta, _ = _train_mlp(to(p0, device), xs[:4096].to(device), ys[:4096].to(device), steps=150)

    parts = label_subset_partition(ys[4096:].numpy(), n_clients, p_shared,
                                   seed=stream_seed(seed, 1))
    idx = torch.from_numpy(np.stack(_client_subsets(parts, n_eval, upto=False)) + 4096)
    rep = lambda v: torch.full((n_clients,), v, dtype=torch.float32, device=device)
    obj = MetricObjective(
        base=MLPParams(*(t.expand(n_clients, *t.shape).contiguous() for t in theta)),
        xs=xs[idx].to(device),
        ys=ys[idx].to(device),
        scale=rep(scale),
        noise_std=rep(noise_std),
        n_classes=rep(7.0),
    )
    return obj, theta.w2.numel() + theta.b2.numel()


def _perturbed(cps: MetricObjective, x_unit: torch.Tensor) -> MLPParams:
    """theta* with its output layer moved by delta(x), per client and point:
    points (N, K, d) -> w2 (N, K, H, C), b2 (N, K, C); w1, b1 as theta*."""
    n, k, _ = x_unit.shape
    w2, b2 = cps.base.w2, cps.base.b2
    delta = (2.0 * x_unit - 1.0) * cps.scale[:, None, None]
    nw = w2[0].numel()
    dw = delta[..., :nw].reshape(n, k, *w2.shape[1:])
    db = delta[..., nw:].reshape(n, k, *b2.shape[1:])
    return cps.base._replace(w2=w2[:, None] + dw, b2=b2[:, None] + db)


def soft_precision(logits: torch.Tensor, labels: torch.Tensor, n_classes: int) -> torch.Tensor:
    """Macro precision (the non-differentiable metric; argmax inside):
    logits (..., n, C) and labels (..., n) -> (...).  The counts are one-hot
    sums, so nothing is read on the host (the engine's chunks are captured
    on the card)."""
    ph = F.one_hot(torch.argmax(logits, dim=-1), n_classes).to(logits.dtype)  # (..., n, C)
    lh = F.one_hot(labels, n_classes).to(logits.dtype)
    tp = torch.sum(ph * lh, dim=-2)
    fp = torch.sum(ph * (1 - lh), dim=-2)
    support = (torch.sum(lh, dim=-2) > 0).to(logits.dtype)
    prec = tp / torch.clamp_min(tp + fp, 1.0)
    return torch.sum(prec * support, dim=-1) / torch.clamp_min(torch.sum(support, dim=-1), 1.0)


def metric_value(cps: MetricObjective, x_unit: torch.Tensor) -> torch.Tensor:
    """f_i(x) = 1 - precision_i(theta* + delta(x)) (minimize), at per-client
    points (N, ..., d) -> (N, ...)."""
    n, d = x_unit.shape[0], x_unit.shape[-1]
    theta = _perturbed(cps, x_unit.reshape(n, -1, d))
    h = torch.tanh(cps.xs @ theta.w1 + theta.b1.unsqueeze(-2))  # (N, n_eval, H)
    lg = h[:, None] @ theta.w2 + theta.b2.unsqueeze(-2)  # (N, K, n_eval, C)
    return (1.0 - soft_precision(lg, cps.ys[:, None, :], 7)).reshape(x_unit.shape[:-1])


def metric_query(cps: MetricObjective, x_unit: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Noisy query y = f_i(x) + sigma_i z with z ~ N(0, 1): (N, ..., d) -> (N, ...)."""
    return metric_value(cps, x_unit) + _lead(cps.noise_std, z) * z


def metric_global_value(cps: MetricObjective, x_unit: torch.Tensor) -> torch.Tensor:
    """F(x) = mean_i f_i(x) at one point x (d,) -> ()."""
    return torch.mean(metric_value(cps, x_unit.expand(cps.xs.shape[0], -1)))


# ---------------------------------------------------------------------------
# 3) LM-backbone objective: FZooS x architecture zoo
# ---------------------------------------------------------------------------


class LMObjective(NamedTuple):
    """Perturb the final-norm gains of a zoo model; f_i = client-batch loss."""

    batches_tokens: torch.Tensor  # (N, b, l) int64
    batches_labels: torch.Tensor  # (N, b, l) int64
    scale: torch.Tensor  # (N,)
    noise_std: torch.Tensor  # (N,)


def make_lm_objective(
    seed: int,
    cfg: ModelConfig,
    n_clients: int,
    batch: int = 2,
    seq: int = 32,
    scale: float = 0.5,
    noise_std: float = 0.001,
    device: str | torch.device = "cuda",
) -> LMObjective:
    """Each client's token batch, uniform over the vocabulary, drawn on the
    CPU from ``(seed, 0)``: sequences of ``seq + 1`` tokens, the first
    ``seq`` the inputs and the last ``seq`` the labels."""
    device = resolve_device(device)
    toks = torch.randint(0, cfg.vocab_size, (n_clients, batch, seq + 1),
                         generator=_cpu_generator(seed, 0))
    rep = lambda v: torch.full((n_clients,), v, dtype=torch.float32, device=device)
    return LMObjective(
        batches_tokens=toks[..., :-1].contiguous().to(device),
        batches_labels=toks[..., 1:].contiguous().to(device),
        scale=rep(scale),
        noise_std=rep(noise_std),
    )


def lm_gains(final_norm: torch.Tensor, scale: torch.Tensor, x_unit: torch.Tensor
             ) -> torch.Tensor:
    """The final-norm gains of per-client points (N, K, d): final_norm +
    (scale_i * (x - 1/2)), the shift computed in float32 and cast to the
    gains' dtype, as the reference's (so bf16 gains match it bit for bit)."""
    return final_norm + (scale[:, None, None] * (x_unit - 0.5)).to(final_norm.dtype)


def lm_values(cfg: ModelConfig, params: dict, cps: LMObjective, gains: torch.Tensor,
              policy: Optional[ShardingPolicy] = None, routes: Optional[Routes] = None
              ) -> torch.Tensor:
    """f_i at K sets of gains a client (N, K, d) -> (N, K): one forward pass
    of N*K*b sequences, every sequence of client i's batch with its set's
    gains; f_i is the batch's mean token NLL plus the router's auxiliary
    loss, over 10.  Each (client, point) is its own group of b sequences
    (``forward``'s ``groups``): its MoE capacity, drops and aux are those
    of the reference's forward of that point alone.  ``routes`` as
    ``forward``'s."""
    policy = policy or ShardingPolicy(remat=False)
    n, k, d = gains.shape
    b, l = cps.batches_tokens.shape[1:]
    every = lambda t: t[:, None].expand(n, k, b, l).reshape(n * k * b, l)
    final = gains[:, :, None, None, :].expand(n, k, b, 1, d).reshape(n * k * b, 1, d)
    logits, aux = forward(dict(params, final_norm=final), cfg,
                          {"tokens": every(cps.batches_tokens)}, policy, groups=n * k,
                          routes=routes)
    nll, valid = token_nll(logits, every(cps.batches_labels))
    loss = (nll.reshape(n, k, b * l).sum(-1)
            / torch.clamp_min(valid.reshape(n, k, b * l).sum(-1), 1))
    return (loss + cfg.router_aux_weight * aux.reshape(n, k)) / 10.0


def make_lm_query(cfg: ModelConfig, params: dict, policy: Optional[ShardingPolicy] = None):
    """Returns (query_fn, global_value_fn, dim, value_fn) of the model
    ``cfg`` with ``params`` (``repro_torch.models.init_params``, or the
    reference's carried across by ``convert.lm_params``).  The ZOO input x
    (in [0,1]^d, d = d_model) shifts the final-norm gains (``lm_gains``).
    ``value(cps, x)`` takes per-client points (N, ..., d) and returns
    (N, ...); the points of a call run as one forward pass
    (``lm_values``)."""
    check_ported(cfg)
    policy = policy or ShardingPolicy(remat=False)
    base = params["final_norm"]

    def value(cps: LMObjective, x_unit: torch.Tensor) -> torch.Tensor:
        n, d = x_unit.shape[0], x_unit.shape[-1]
        gains = lm_gains(base, cps.scale, x_unit.reshape(n, -1, d))
        return lm_values(cfg, params, cps, gains, policy).reshape(x_unit.shape[:-1])

    def query(cps: LMObjective, x_unit: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """Noisy query y = f_i(x) + sigma_i z with z ~ N(0, 1): (N, ..., d) -> (N, ...)."""
        return value(cps, x_unit) + _lead(cps.noise_std, z) * z

    def global_value(cps: LMObjective, x_unit: torch.Tensor) -> torch.Tensor:
        """F(x) = mean_i f_i(x) at one point x (d,) -> ()."""
        return torch.mean(value(cps, x_unit.expand(cps.scale.shape[0], -1)))

    return query, global_value, cfg.d_model, value
