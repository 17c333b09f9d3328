"""Batched serving launcher (port of ``repro.launch.serve``): prefill a batch
of prompts, then decode, on the card by default.

    python -m repro_torch.launch.serve --arch qwen1-5-0-5b \\
        --variant smoke --batch-size 4 --prompt-len 32 --gen-len 16

    # on the CPU
    python -m repro_torch.launch.serve --device cpu --arch whisper-base

Run from the repository root with ``PYTHONPATH=src``.  The flags are the
reference's, plus ``--device`` (default ``cuda``, which raises when no
card is present).  The parameters are ``models.init_params`` of
``--seed``; the prompts, the vlm's stub patches, the encoder-decoder's
stub frames and the sampling draws come from one ``torch.Generator`` on
the run's device seeded with ``--seed``.

On the card the decode loop is the reference's ``jax.jit(decode_step)``
as one captured CUDA graph: a decode step and the sampling of its token
into a static buffer, captured once a call after one eager warm-up step
on a clone of the cache, then replayed once a token with no host read in
the loop (``Decoder``).  A capture that fails raises; nothing falls back
to the eager step.  On the CPU the loop runs eagerly.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.configs import get_config
from repro_torch.core import graphs
from repro_torch.device import resolve_device
from repro_torch.launch import common
from repro_torch.models.layers import _wide
from repro_torch.models.model import decode_step, prefill
from repro_torch.models.params import init_params
from repro_torch.sharding.rules import ShardingPolicy

#: Decode graphs captured and replayed (``Decoder``).
COUNTS = {"captures": 0, "replays": 0}


def sample_token(logits: torch.Tensor, temperature: float,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Next token ids from (B, V) logits: at temperature 0 the argmax (the
    first maximal index, as ``jnp.argmax``), above it a draw from the
    categorical of ``logits / temperature`` by the Gumbel-max rule (as
    ``jax.random.categorical``), its uniforms from ``generator``.  Torch
    cannot replay the reference's threefry draws: a sampled run's tokens
    are the port's own.  -> (B, 1) int64."""
    if temperature > 0:
        u = torch.rand(logits.shape, generator=generator, dtype=torch.float32,
                       device=logits.device).clamp_min_(torch.finfo(torch.float32).tiny)
        return torch.argmax(_wide(logits) / temperature - torch.log(-torch.log(u)), -1,
                            keepdim=True)
    return torch.argmax(logits, -1, keepdim=True)


class Decoder:
    """Decode steps from a prefilled cache, each sampling its next token.

    ``token`` (B, 1) is the first token to decode.  ``step()`` runs one
    decode step on ``cache`` (in place) and leaves its logits in
    ``logits`` and the sampled next token in ``token``.  On a CUDA device
    (unless ``eager``) the step is one captured graph: before the capture
    one eager step runs on a side stream, on a clone of the cache and with
    a generator of its own, so that cuBLAS's handles and workspaces are set
    up outside the capture and the run's state and draws are untouched;
    ``generator`` is registered with the graph, so a replay draws from its
    current state and advances it as an eager step would.
    ``capture_secs`` is the warm-up's and the capture's host time.
    """

    def __init__(self, cfg, params, cache, token: torch.Tensor, policy, temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None, eager: bool = False):
        self.cfg, self.params, self.policy = cfg, params, policy
        self.temperature, self.generator = temperature, generator
        self.cache = cache
        self.token = token.clone()
        self.logits = None
        self.graph = None
        self.capture_secs = 0.0
        if token.device.type == "cuda" and not eager:
            self._capture()

    def _step(self, cache, token: torch.Tensor, generator) -> torch.Tensor:
        """Decode ``token`` on ``cache``, sample the next token into it."""
        logits, _ = decode_step(self.params, self.cfg, cache, token, self.policy)
        token.copy_(sample_token(logits, self.temperature, generator))
        return logits

    def _capture(self) -> None:
        t0 = time.perf_counter()
        dev = self.token.device
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            own = torch.Generator(device=dev).manual_seed(0) if self.temperature > 0 else None
            self._step(graphs.clone(self.cache), self.token.clone(), own)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        if self.temperature > 0 and self.generator is not None:
            self.graph.register_generator_state(self.generator)
        with torch.cuda.graph(self.graph):
            self.logits = self._step(self.cache, self.token, self.generator)
        torch.cuda.synchronize(dev)
        COUNTS["captures"] += 1
        self.capture_secs = time.perf_counter() - t0

    def step(self) -> None:
        if self.graph is None:
            self.logits = self._step(self.cache, self.token, self.generator)
        else:
            self.graph.replay()
            COUNTS["replays"] += 1

    def run(self, gen_len: int) -> torch.Tensor:
        """``gen_len`` steps; -> the tokens decoded, (B, gen_len), on the
        device (the first is the token given, each next one sampled from
        the step before)."""
        out = torch.empty((self.token.shape[0], gen_len), dtype=torch.int64,
                          device=self.token.device)
        for i in range(gen_len):
            out[:, i:i + 1].copy_(self.token)
            self.step()
        return out


def generate(cfg, params, batch: dict, policy, gen_len: int, cache_len: Optional[int] = None,
             temperature: float = 0.0, generator: Optional[torch.Generator] = None):
    """Prefill ``batch``, then ``gen_len`` decode steps (``Decoder``;
    captured on the card).  ``cache_len`` defaults to the
    prompt's length + ``gen_len`` + 1, as the reference's ``main`` passes.
    The PREFILL logits go through the same sampling rule as every decode
    step (the reference's fix: its first token was once always the
    argmax).  -> (tokens (B, gen_len) on the device, the cache)."""
    cache_len = cache_len or batch["tokens"].shape[1] + gen_len + 1
    logits, cache = prefill(params, cfg, batch, policy, cache_len=cache_len)
    token = sample_token(logits, temperature, generator)
    decoder = Decoder(cfg, params, cache, token, policy, temperature, generator)
    return decoder.run(gen_len), cache


def stub_batch(cfg, batch_size: int, prompt_len: int, generator: torch.Generator) -> dict:
    """The reference's serving batch, drawn from ``generator`` on its
    device: random prompt tokens; for the vlm family stub patch embeddings
    (0.02 normals) over the first ``n_patches`` positions and the text's
    positions in all three M-RoPE components; for the encoder-decoder stub
    frames (0.02 normals, ``enc_seq`` of them)."""
    dev = generator.device
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (batch_size, prompt_len),
                                     generator=generator, device=dev)}
    if cfg.arch_type == "vlm":
        batch["patches"] = 0.02 * torch.randn((batch_size, cfg.n_patches, cfg.d_model),
                                              generator=generator, device=dev)
        batch["positions"] = torch.arange(prompt_len, device=dev)[None, :, None].expand(
            batch_size, prompt_len, 3)
    if cfg.arch_type == "encdec":
        batch["frames"] = 0.02 * torch.randn((batch_size, cfg.enc_seq, cfg.d_model),
                                             generator=generator, device=dev)
    return batch


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    common.add_arch_flag(ap)
    ap.add_argument("--variant", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda)")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, args.variant)
    policy = ShardingPolicy(remat=False)
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(args.seed, cfg, dev)
    batch = stub_batch(cfg, args.batch_size, args.prompt_len, generator)

    t0 = time.perf_counter()
    out, _ = generate(cfg, params, batch, policy, args.gen_len,
                      args.prompt_len + args.gen_len + 1, args.temperature, generator)
    out = out.cpu()
    dt = time.perf_counter() - t0
    n_tok = out.shape[0] * out.shape[1]
    print(f"generated {tuple(out.shape)} tokens in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s incl. compile)")
    print("first sequence:", out[0].tolist())


if __name__ == "__main__":
    main()
