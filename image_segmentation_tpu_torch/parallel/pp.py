"""Pipeline parallelism (GPipe) over the ViT block stack.

Counterpart of image_segmentation_tpu/parallel/pp.py
(`stack_block_params` :44, `unstack_block_params` :52,
`shard_stacked_params` :62, `pipeline_blocks` :69). The mesh's model axis
holds S stages; stage s owns the blocks [s·L/S, (s+1)·L/S) of the stacked
block parameters (a leading layer dim), and M micro-batches go through
the classic (M + S − 1)-tick schedule: at tick t stage 0 takes
micro-batch t, each stage runs its blocks on what it holds, and the
states shift one stage on. JAX runs it as one `shard_map` program with a
`ppermute` shift; here every process runs the same tick loop.

  * The shift is `mesh.gather_slots` over the model group (one all-reduce
    of a buffer in which each stage fills its slot; each stage takes its
    predecessor's). Gloo takes no point-to-point send or recv of CUDA
    tensors, and it does take this, so ranks that share a card run it as
    ranks with a card each do. Its backward is the reverse shift (the
    gather's adjoint), as JAX's transposed `ppermute` is.
  * Bubble ticks: JAX runs every stage on every tick, on zeros in the
    bubble, and masks the results away. A stage here skips its bubble
    ticks (it passes its state through): the results are the same, and a
    stage launches its blocks M · L/S times a forward, not (M + S − 1) ·
    L/S.
  * `(final, per_layer)` are assembled on every stage with masked sums
    over the model group, as JAX's `psum`s (:143-156): the last stage's
    outputs, and each stage's own layers' taps in its slot of (L, N, ...).
    The sums' backward hands the (replicated) upstream gradient on as it
    is (`mesh.sum_replicated`), so a stage's gradients are those of one
    loss, as `jax.grad` of the shard_map gives them, not of the sum of
    every stage's copy of it.
  * Gradients flow through the plain tensor ops, the shift and the sums:
    every stage calls the backward's collectives in the same order, the
    reverse of the ticks. Each shift's output also reaches the results
    through a term multiplied by 0, and in grad mode a bubble's zeros
    require grad, so that every stage runs every shift's backward.
    The kernels have no backward and refuse autograd on a card
    (`_build.refuse_grad`): on a card the pipeline runs the frozen
    encoder's forward, and the gradient runs on the CPU through the
    plain versions, as JAX's test does (test_pp.py:73).

`block_fn(one_layer_params, x)` applies one block; for the port's
`TransformerBlock` that is `torch.func.functional_call(block, params,
(x,))` (`block_fn_for`).
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import torch

from image_segmentation_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    Mesh,
    gather_slots,
    sum_replicated,
)

PREFIX = "encoder.layers."


def stack_block_params(state: Mapping[str, torch.Tensor], num_layers: int,
                       prefix: str = PREFIX) -> Dict[str, torch.Tensor]:
    """The blocks' tensors `{prefix}{i}.{name}` of a state dict (a ClipViT's:
    `encoder.layers.{i}....`) stacked into one tensor per name with a
    leading layer dim of `num_layers`."""
    names = [k[len(f"{prefix}0."):] for k in state if k.startswith(f"{prefix}0.")]
    return {n: torch.stack([state[f"{prefix}{i}.{n}"] for i in range(num_layers)])
            for n in names}


def unstack_block_params(stacked: Mapping[str, torch.Tensor],
                         prefix: str = PREFIX) -> Dict[str, torch.Tensor]:
    """The inverse of `stack_block_params`: `{prefix}{i}.{name}` entries."""
    num_layers = next(iter(stacked.values())).shape[0]
    return {f"{prefix}{i}.{n}": t[i] for n, t in stacked.items() for i in range(num_layers)}


def shard_stacked_params(stacked: Mapping[str, torch.Tensor], mesh: Mesh,
                         axis: str = MODEL_AXIS) -> Dict[str, torch.Tensor]:
    """This stage's layers [s·L/S, (s+1)·L/S) of the stacked parameters, for
    stage s of the S on `axis` (a differentiable slice of the stacked
    tensors)."""
    _, stages, stage = mesh.axis(axis)
    total = next(iter(stacked.values())).shape[0]
    if total % stages:
        raise ValueError(f"{total} layers not divisible by {stages} stages")
    n = total // stages
    return {k: v.narrow(0, stage * n, n) for k, v in stacked.items()}


def block_fn_for(block: torch.nn.Module) -> Callable:
    """block_fn(one layer's parameters, x) → `block` applied with them."""
    return lambda params, x: torch.func.functional_call(block, dict(params), (x,))


def pipeline_blocks(block_fn: Callable, local: Mapping[str, torch.Tensor], x: torch.Tensor,
                    mesh: Mesh, num_microbatches: int,
                    axis: str = MODEL_AXIS) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run `x` through the whole stacked block sequence as an S-stage
    pipeline over `mesh`'s `axis`, on every process of its group.

    `local`: this stage's `shard_stacked_params` slice of the stacked
    parameters (leading dim L/S), which also raises JAX's layer
    divisibility error (pp.py:92). `x`: (N, ...), the same on every
    stage, N % num_microbatches == 0. Returns (final (N, ...), per_layer
    (L, N, ...)) on every stage: per_layer[i] is block i's output, ClipViT's
    hidden_states[i + 1]."""
    group, stages, stage = mesh.axis(axis)
    m = num_microbatches
    if x.shape[0] % m:
        raise ValueError(f"batch {x.shape[0]} not divisible by {m} microbatches")
    per_stage = next(iter(local.values())).shape[0]
    total = per_stage * stages
    layers = [{k: v[i] for k, v in local.items()} for i in range(per_stage)]
    mb = x.reshape((m, x.shape[0] // m) + tuple(x.shape[1:]))
    need_grad = torch.is_grad_enabled() and (
        x.requires_grad or any(v.requires_grad for v in local.values()))

    def zeros():
        return torch.zeros_like(mb[0]).requires_grad_(need_grad)

    state, outs, taps = zeros(), [None] * m, [None] * m
    sink = x.new_zeros(())
    ticks = m + stages - 1
    for t in range(ticks):
        if stage == 0 and t < m:
            state = mb[t]
        i = t - stage  # the micro-batch this stage holds at tick t
        if 0 <= i < m:
            mine = []
            for p in layers:
                state = block_fn(p, state)
                mine.append(state)
            outs[i], taps[i] = state, torch.stack(mine)
        if t < ticks - 1:
            ring = gather_slots(state, group, stages, stage)
            state = ring[(stage - 1) % stages]
            if need_grad:
                sink = sink + (ring * 0).sum().to(sink.dtype)

    def psum(t):  # a stage axis of one runs no collective
        return sum_replicated(t, group) if stages > 1 else t

    last = 1.0 if stage == stages - 1 else 0.0
    final = psum(torch.stack(outs) * last + sink)
    final = final.reshape(x.shape)
    mine = torch.stack(taps, 1)  # (L/S, M, mb, ...)
    pad = lambda n: mine.new_zeros((n,) + tuple(mine.shape[1:]))  # noqa: E731
    full = torch.cat([pad(stage * per_stage), mine + sink,
                      pad((stages - 1 - stage) * per_stage)])
    per_layer = psum(full).reshape((total,) + tuple(x.shape))
    return final, per_layer
