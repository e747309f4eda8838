"""CUDA graphs of the train step's micro-batch forward and backward.

No JAX counterpart: XLA compiles the whole step into one program. Here
`train.steps.train_step` enqueues each micro-batch's train-mode forward
and its backward from Python, hundreds of small launches each, and on a
card the host's enqueue, not the kernels, then sets the step. So the two
are captured once per micro-batch shape as a pair of CUDA graphs
(`GraphPair`) and replayed for every micro-batch of that shape:
  * the forward graph: `model.forward` on static inputs, in train mode,
    the BatchNorm running-statistic updates included;
  * the backward graph: the gradients of the static output (or of each
    output, where the forward returns a tuple of tensors, as models/sam.py
    returns its masks and IoU predictions), from static output gradients,
    with respect to every parameter that gets one, added into gradient
    buffers the pair owns.
The caller's loss and its backward stay eager (the loss is a Python
callable). `loss.backward()` reaches the pair through `_Replay`, an
autograd function whose forward replays the forward graph and whose
backward replays the backward graph. After the micro-batches the buffers
become the parameters' `.grad` (`GraphPair.hand_grads`): AccumulateGrad
never sees them, so no `.grad` aliases a buffer that a replay writes, and
the accumulation runs inside the graph. A `.grad` so handed is the pair's
buffer until the pair's next step zeroes it.

The pairs live on the train state (`TrainState.graphs`, a
`MicroBatchGraphs`), so that dropping the state frees their memory pools.
A pair holds its pool between steps, where the eager step frees its
activations after each backward; so the pairs of every state in a process
hold at most `MEMORY_SHARE` of the card's memory together (`_GraphMemory`:
what each capture added to the allocator's reserved memory). A pair that
would pass it is dropped and its shape runs eagerly: the bound keeps a
process that holds several train states (the probes, the studies) within
the memory its eager steps had, and it leaves large micro-batches eager,
whose kernels outlast the host's enqueue anyway. A state keeps at most
`MAX_SHAPES` shapes; a micro-batch of another shape runs eagerly. A step
that runs eagerly for a hook drops the state's pairs, so that their
memory goes back to the eager steps.

Capture (`_capture`) runs `WARMUP_PASSES` eager forwards and backwards on
a side stream, then records the two graphs. It leaves no trace on the
state: the model's buffers (the BatchNorm running statistics) are put
back as they were, the warm-up writes no `.grad`, the optimizer is not
touched, and the kernels' launch counters (`ops.launch_counts`) read as
if the warm-up had not run; a replay adds to them the launches its graph
holds. A model that cannot be captured (the capture raises)
runs eagerly at that shape, with a warning.

A micro-batch replays only where the step can observe that a replay does
what the eager forward and backward would (`eager_reasons`,
`model_signature`): the parameters and inputs on a CUDA device, gradients
on, one process (train-mode BatchNorm's global sums and the gradient
all-reduce are collectives), no spatial partitioning (`spatial`) and no
tensor parallelism (`tp_mesh`), no autocast, no input that requires grad,
and no hook that a replay would skip: a forward hook or pre-hook on the
root module is called around the replay, as `Module.__call__` would call
it; any hook on a submodule, a backward hook, a parameter's hook or a
global module hook keeps the step eager. The parameters' and buffers'
addresses, shapes, dtypes and gradient flags are the graphs' key besides
the inputs' shapes and dtypes: a model whose tensors moved is captured
anew (a `load_state_dict`, which copies in place, is not such a move).
No capture starts while torch.profiler records; replays are traced.
"""
from __future__ import annotations

import collections
import threading
import warnings
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from image_segmentation_tpu_torch.ops import add_launches, launch_counts, launches_since
from image_segmentation_tpu_torch.parallel.mesh import world_size
from image_segmentation_tpu_torch.utils import profiling

# micro-batch shapes a train state keeps a graph pair for; others run eagerly
MAX_SHAPES = 4
# eager forwards and backwards on the capture stream before the capture
WARMUP_PASSES = 3
# share of a card's memory that the pairs of every train state in a process
# may hold together; a pair that would pass it is dropped and its shape
# runs eagerly (module docstring)
MEMORY_SHARE = 1 / 8

_GLOBAL_HOOKS = ("_global_forward_pre_hooks", "_global_forward_hooks",
                 "_global_forward_hooks_always_called", "_global_backward_pre_hooks",
                 "_global_backward_hooks")


def eager_reasons(model: nn.Module, inputs: Sequence[torch.Tensor]) -> List[str]:
    """Why a micro-batch of `inputs` runs `model` eagerly: empty when a
    graph pair may replay it (module docstring). Every reason that holds
    is listed."""
    reasons = []
    p = next(model.parameters(), None)
    if p is None or not p.is_cuda or any(x.device != p.device for x in inputs):
        reasons.append("not on a CUDA device")
    if not torch.is_grad_enabled():
        reasons.append("gradients are off")
    world = world_size()
    if world > 1:
        reasons.append(f"a process group of {world}")
    if getattr(model, "spatial", None) is not None:
        reasons.append("spatial partitioning")
    if getattr(model, "tp_mesh", None) is not None:
        reasons.append("tensor parallelism")
    if torch.is_autocast_enabled("cuda"):
        reasons.append("autocast")
    if any(x.requires_grad for x in inputs):
        reasons.append("an input requires grad")
    return reasons


def model_signature(model: nn.Module) -> Optional[tuple]:
    """The address, shape, dtype (and, for a parameter, gradient flag) of
    each of the model's parameters and buffers, which a captured graph
    reads and writes; None when the model holds a hook that a replay would
    skip (module docstring)."""
    mod = nn.modules.module
    if any(getattr(mod, name, None) for name in _GLOBAL_HOOKS):
        return None
    if (model._forward_pre_hooks_with_kwargs or model._forward_hooks_with_kwargs
            or model._forward_hooks_always_called):
        return None
    sig = []
    for m in model.modules():
        if m._backward_hooks or m._backward_pre_hooks or (
                m is not model and (m._forward_hooks or m._forward_pre_hooks)):
            return None
        for t in m._parameters.values():
            if t is not None:
                if t._backward_hooks or getattr(t, "_post_accumulate_grad_hooks", None):
                    return None
                sig.append((t.data_ptr(), t.shape, t.dtype, t.requires_grad))
        for t in m._buffers.values():
            if t is not None:
                sig.append((t.data_ptr(), t.shape, t.dtype))
    return tuple(sig)


class _GraphMemory:
    """The device memory that the live pairs of the process hold, by
    device: what each pair's capture added to the allocator's reserved
    memory (its graphs' pool, its static tensors and gradient buffers),
    given back when the pair is dropped."""

    def __init__(self):
        self.held: Dict[torch.device, int] = collections.Counter()
        self._lock = threading.Lock()

    def fits(self, device: torch.device, nbytes: int) -> bool:
        total = torch.cuda.get_device_properties(device).total_memory
        return self.held[device] + nbytes <= MEMORY_SHARE * total

    def hold(self, pair: "GraphPair", device: torch.device, nbytes: int) -> None:
        with self._lock:
            self.held[device] += nbytes
        weakref.finalize(pair, self._give_back, device, nbytes)

    def _give_back(self, device: torch.device, nbytes: int) -> None:
        with self._lock:
            self.held[device] -= nbytes


_MEMORY = _GraphMemory()


def _input_key(inputs: Sequence[torch.Tensor]) -> tuple:
    return tuple((x.shape, x.dtype) for x in inputs)


class _Replay(torch.autograd.Function):
    """Forward: the inputs copied into the pair's static inputs, the forward
    graph replayed, its static output (or outputs) returned. Backward: the
    outputs' gradients copied into the static output gradients, the
    backward graph replayed (it adds into the pair's gradient buffers); no
    gradient flows out. `anchor` is a leaf that requires grad, so that the
    outputs are part of the autograd graph."""

    @staticmethod
    def forward(ctx, anchor, pair, *xs):
        for s, x in zip(pair.inputs, xs):
            s.copy_(x)
        pair.fwd.replay()
        add_launches(pair.launched)
        ctx.pair = pair
        if pair.multi:
            return tuple(o.detach() for o in pair.out)
        return pair.out.detach()

    @staticmethod
    def backward(ctx, *grads):
        pair = ctx.pair
        for g_out, g in zip(pair.grad_outs, grads):
            g_out.copy_(g)
        pair.bwd.replay()
        return (None, None) + (None,) * len(pair.inputs)


class GraphPair:
    """The forward and backward graphs of one micro-batch shape, their
    static tensors and the gradient buffers of `params`. `out` is the
    static output, or the tuple of them where the forward returns a tuple
    (`multi`); `grad_outs` holds a static gradient for each (a tensor
    alone for a single output)."""

    def __init__(self, key, inputs, fwd, bwd, out, grad_outs, params, bufs, launched):
        self.key, self.inputs, self.fwd, self.bwd = key, inputs, fwd, bwd
        self.out, self.params, self.bufs = out, params, bufs
        self.multi = isinstance(out, tuple)
        self.grad_outs = (tuple(grad_outs) if isinstance(grad_outs, (tuple, list))
                          else (grad_outs,))
        self.launched = launched  # the kernel launches the forward graph holds
        device = (out[0] if self.multi else out).device
        self.anchor = torch.empty(0, device=device, requires_grad=True)

    def begin_step(self) -> None:
        """Zero the gradient buffers; a buffer still some parameter's `.grad`
        (one the optimizer does not clear) is handed over as a copy first."""
        for p, b in zip(self.params, self.bufs):
            if p.grad is b:
                p.grad = b.clone()
        torch._foreach_zero_(self.bufs)

    def forward(self, model: nn.Module, xs: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        """The micro-batch's output, under the root module's forward
        pre-hooks and hooks as `Module.__call__` runs them: replayed, or
        eager where a pre-hook handed the forward inputs of another shape."""
        for hook in model._forward_pre_hooks.values():
            res = hook(model, xs)
            if res is not None:
                xs = res if isinstance(res, tuple) else (res,)
        if _input_key(xs) == self.key:
            out = _Replay.apply(self.anchor, self, *xs)
            profiling.count("train.replays")
        else:
            out = model.forward(*xs)
            profiling.count("train.eager_micro_batches")
        for hook in model._forward_hooks.values():
            res = hook(model, xs, out)
            if res is not None:
                out = res
        return out

    def hand_grads(self) -> None:
        """The step's summed gradients to the parameters' `.grad`."""
        for p, b in zip(self.params, self.bufs):
            if p.grad is None:
                p.grad = b
            else:  # eager micro-batches of this step, or a grad kept from before
                p.grad.add_(b)


class MicroBatchGraphs:
    """The graph pairs of one train state, by micro-batch input shapes and
    dtypes (None marks a shape that could not be captured), for the model
    tensors of `signature`."""

    def __init__(self):
        self.pairs: Dict[tuple, Optional[GraphPair]] = {}
        self.signature: Optional[tuple] = None

    def for_step(self, model: nn.Module, xs: Tuple[torch.Tensor, ...]) -> Optional[GraphPair]:
        """The pair that replays this step's micro-batches (shaped as `xs`),
        captured now if it is new, its buffers zeroed; None when they run
        eagerly."""
        if eager_reasons(model, xs):
            return None
        sig = model_signature(model)
        if sig is None:  # the pairs' memory goes back to the eager steps
            self.pairs.clear()
            self.signature = None
            return None
        if sig != self.signature:
            self.pairs.clear()
            self.signature = sig
        key = _input_key(xs)
        if key not in self.pairs:
            if len(self.pairs) >= MAX_SHAPES or torch.autograd._profiler_enabled():
                return None
            with profiling.span("train.capture"):
                self.pairs[key] = _capture(model, xs)
            if self.pairs[key] is not None:
                profiling.count("train.captures")
        pair = self.pairs[key]
        if pair is not None:
            pair.begin_step()
        return pair


def _outputs(out) -> Optional[Tuple[torch.Tensor, ...]]:
    """The forward's output as a tuple of tensors that carry a gradient
    (a tensor, or a tuple of them); None for anything else, which a pair
    cannot replay."""
    outs = out if isinstance(out, tuple) else (out,)
    if not outs or not all(isinstance(o, torch.Tensor) and o.grad_fn is not None
                           for o in outs):
        return None
    return outs


def _capture(model: nn.Module, xs: Tuple[torch.Tensor, ...]) -> Optional[GraphPair]:
    """Warm up and capture the pair for micro-batches shaped as `xs`
    (module docstring); None if the model cannot be captured."""
    device = xs[0].device
    params = [p for p in model.parameters() if p.requires_grad]
    buffers = list(model.buffers())
    kept = [b.detach().clone() for b in buffers]
    counts = launch_counts()
    inputs = tuple(x.detach().clone() for x in xs)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    try:
        with torch.cuda.stream(side):
            for _ in range(WARMUP_PASSES):
                outs = _outputs(model.forward(*inputs))
                if outs is None or not params:
                    return None
                grads = torch.autograd.grad(outs, params, [torch.zeros_like(o) for o in outs],
                                            allow_unused=True)
            used = [p for p, g in zip(params, grads) if g is not None]
            del outs, grads
            if not used:
                return None
        torch.cuda.current_stream(device).wait_stream(side)
        fwd, bwd = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        before = launch_counts()
        torch.cuda.empty_cache()  # as the capture does first, so `reserved` counts the pair
        reserved = torch.cuda.memory_reserved(device)
        with torch.cuda.graph(fwd, stream=side, capture_error_mode="thread_local"):
            out = model.forward(*inputs)
        outs = _outputs(out)
        launched = launches_since(before)
        grad_outs = [torch.empty_like(o) for o in outs]
        bufs = [torch.zeros_like(p) for p in used]
        with torch.cuda.graph(bwd, pool=fwd.pool(), stream=side,
                              capture_error_mode="thread_local"):
            torch._foreach_add_(bufs, torch.autograd.grad(outs, used, grad_outs))
        nbytes = torch.cuda.memory_reserved(device) - reserved
    except RuntimeError as e:
        warnings.warn(f"the micro-batch of shapes {[tuple(x.shape) for x in xs]} could not be "
                      f"captured as a CUDA graph and runs eagerly: {e}")
        return None
    finally:
        torch.cuda.current_stream(device).wait_stream(side)
        with torch.no_grad():
            for b, k in zip(buffers, kept):
                b.copy_(k)
        add_launches({key: -n for key, n in launches_since(counts).items()})
    if not _MEMORY.fits(device, nbytes):
        return None
    static = tuple(o.detach() for o in outs) if isinstance(out, tuple) else out.detach()
    pair = GraphPair(_input_key(xs), inputs, fwd, bwd, static, grad_outs, used, bufs,
                     launched)
    _MEMORY.hold(pair, device, nbytes)
    return pair
