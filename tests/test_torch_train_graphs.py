"""The train step's CUDA graphs (train/graphs.py; train/steps.py
`train_step`).

On the CPU: a step counts its micro-batches as eager and captures
nothing; the engagement rule sends a process group of 2 (gloo), spatial
partitioning and tensor parallelism down the eager path; the model's
signature sees hooks a replay would skip and tensors that moved; and the
replay's autograd wiring, with graphs that re-run the forward and the
backward in Python, accumulates, hands over and keeps gradients as the
eager step does.

On the card (marked `cuda`, skipped elsewhere): the graphed step against
the eager one on the same weights and rows (a no-op forward hook on a
submodule keeps a twin eager), the capture's traces, the shape cache and
its bound, a `load_state_dict` between steps, and the prompt model and
the ClipUNet. The file imports no jax, so on the card run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_train_graphs.py

Tolerance on the card: cuDNN runs deterministic algorithms, so graphed and
eager steps compute the same kernels on the same bytes; the checks allow
one bf16 step (2^-8 relative) for what the capture might reorder.
"""
import copy
import dataclasses

import pytest
import torch

from image_segmentation_tpu_torch.losses import DiceCELoss
from image_segmentation_tpu_torch.models.unet import UNet
from image_segmentation_tpu_torch.train import graphs as G
from image_segmentation_tpu_torch.train.state import TrainState, make_adamw
from image_segmentation_tpu_torch.train.steps import train_step
from image_segmentation_tpu_torch.utils import profiling

torch.set_num_threads(1)

REL = 2.0**-8
COUNTS = ("train.captures", "train.replays", "train.eager_micro_batches")


def _unet_state(device="cpu", base=4, dtype=torch.float32, seed=0):
    model = UNet(base=base, dtype=dtype).init_weights(torch.Generator().manual_seed(seed))
    model = model.to(device, memory_format=torch.channels_last)
    return TrainState(model, *make_adamw(model.parameters()))


def _rows(n, side=32, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(n, side, side, 3, generator=g)
    return x.to(device), torch.randint(0, 4, (n, side, side), generator=g).to(device)


def _counts(log):
    return tuple(log.counts[k] for k in COUNTS)


@pytest.fixture(autouse=True)
def spans_off():
    yield
    profiling.SPANS = None


# On the CPU.


@pytest.mark.parametrize("accum", [1, 3])
def test_cpu_step_counts_eager_micro_batches_and_no_capture(accum):
    st = _unet_state()
    with profiling.record_spans() as log:
        train_step(st, DiceCELoss(), *_rows(2 * accum), accum_steps=accum)
    assert _counts(log) == (0, 0, accum)
    assert "train.capture" not in {s.name for s in log.spans}
    assert not st.graphs.pairs and all(p.grad is not None for p in st.model.parameters())


def test_count_is_a_no_op_with_spans_off():
    assert profiling.SPANS is None
    profiling.count("train.replays")  # no log: nothing to add to, nothing raised
    with profiling.record_spans() as log:
        profiling.count("x")
        profiling.count("x")
    assert log.counts == {"x": 2}


def test_cpu_model_is_eager_for_the_device_alone():
    st = _unet_state()
    x, _ = _rows(2)
    assert G.eager_reasons(st.model, (x,)) == ["not on a CUDA device"]
    with torch.no_grad():
        assert G.eager_reasons(st.model, (x,)) == ["not on a CUDA device", "gradients are off"]
    assert "an input requires grad" in G.eager_reasons(st.model, (x.requires_grad_(),))


@pytest.mark.parametrize("attr,reason", [("spatial", "spatial partitioning"),
                                         ("tp_mesh", "tensor parallelism")])
def test_model_parallel_attributes_keep_the_step_eager(attr, reason):
    st = _unet_state()
    x, _ = _rows(2)
    assert reason not in G.eager_reasons(st.model, (x,))
    setattr(st.model, attr, object())  # the rule reads only that the axis is set
    assert reason in G.eager_reasons(st.model, (x,))


def w_group(rank, world):
    """In a gloo group of `world`: the rule's reasons, and one step's counts."""
    st = _unet_state()
    x, y = _rows(4, seed=rank)
    reasons = G.eager_reasons(st.model, (x,))
    with profiling.record_spans() as log:
        train_step(st, DiceCELoss(), x, y, accum_steps=2)
    return reasons, _counts(log), len(st.graphs.pairs)


def test_process_group_of_two_keeps_the_step_eager(tmp_path):
    for reasons, counts, pairs in spawn(__file__, "w_group", 2, tmp_path):
        assert "a process group of 2" in reasons
        assert counts == (0, 0, 2) and pairs == 0


def test_signature_sees_hooks_a_replay_would_skip():
    model = _unet_state().model
    assert G.model_signature(model) is not None
    for register in (lambda: model.register_forward_pre_hook(lambda m, a: None),
                     lambda: model.register_forward_hook(lambda m, a, o: None)):
        h = register()  # on the root: called around the replay
        assert G.model_signature(model) is not None
        h.remove()
    for register in (lambda: model.down1.register_forward_hook(lambda m, a, o: None),
                     lambda: model.down2.conv.register_forward_pre_hook(lambda m, a: None),
                     lambda: model.register_full_backward_hook(lambda m, gi, go: None),
                     lambda: model.register_forward_hook(lambda m, a, k, o: None,
                                                         with_kwargs=True),
                     lambda: model.output.weight.register_hook(lambda g: None),
                     lambda: torch.nn.modules.module.register_module_forward_hook(
                         lambda m, a, o: None)):
        h = register()
        assert G.model_signature(model) is None
        h.remove()
    assert G.model_signature(model) is not None


def test_signature_follows_moved_tensors_not_loaded_values():
    model = _unet_state().model
    sig = G.model_signature(model)
    model.load_state_dict(_unet_state(seed=1).model.state_dict())  # in place
    assert G.model_signature(model) == sig
    model.output.weight.requires_grad_(False)
    assert G.model_signature(model) != sig
    model.output.weight.requires_grad_(True)
    model.output.weight = torch.nn.Parameter(model.output.weight.detach().clone())
    assert G.model_signature(model) != sig


class _PythonGraph:
    """A stand-in for a CUDA graph whose replay re-runs its work in Python."""

    def __init__(self, work):
        self.work = work

    def replay(self):
        self.work()


def _linear_pair(model):
    """A GraphPair for `model` (a Linear) on (2, 3) inputs whose graphs are
    the forward and the weight/bias gradients written out, as a capture
    would record them."""
    x, out = torch.zeros(2, 3), torch.zeros(2, 4)
    grad_out = torch.zeros(2, 4)
    w, b = model.weight, model.bias
    bufs = [torch.zeros_like(w), torch.zeros_like(b)]

    def fwd():
        with torch.no_grad():
            out.copy_(x @ w.T + b)

    def bwd():
        bufs[0].add_(grad_out.T @ x)
        bufs[1].add_(grad_out.sum(0))

    return G.GraphPair(G._input_key((x,)), (x,), _PythonGraph(fwd), _PythonGraph(bwd), out,
                       grad_out, [w, b], bufs, {})


def test_replay_wiring_accumulates_and_hands_gradients_as_the_eager_step():
    torch.manual_seed(0)
    model = torch.nn.Linear(3, 4)
    eager = copy.deepcopy(model)
    pair = _linear_pair(model)
    xs = [torch.randn(2, 3) for _ in range(3)]
    calls = []
    model.register_forward_pre_hook(lambda m, a: calls.append("pre"))
    model.register_forward_hook(lambda m, a, o: calls.append("post") or o * 2)
    eager.register_forward_hook(lambda m, a, o: o * 2)
    for step in range(2):
        pair.begin_step()
        with profiling.record_spans() as log:
            for x in xs:
                pair.forward(model, (x,)).square().sum().backward()
        pair.hand_grads()
        eager.zero_grad(set_to_none=True)
        for x in xs:
            eager(x).square().sum().backward()
        assert log.counts["train.replays"] == 3
        assert model.weight.grad is pair.bufs[0] and model.bias.grad is pair.bufs[1]
        torch.testing.assert_close(model.weight.grad, eager.weight.grad)
        torch.testing.assert_close(model.bias.grad, eager.bias.grad)
        model.weight.grad = model.bias.grad = None
    assert calls == ["pre", "post"] * 6
    assert pair.anchor.grad is None


def test_a_replay_credits_k4s_many_token_launches():
    """A capture records every launch counter that moved (the ops layer's
    snapshot, `_build.launch_counts`, K4's many-token count among them) and
    each replay adds them again: a SAM ViT-B forward at micro-batch 8 holds
    12 K4 launches, all v3."""
    from image_segmentation_tpu_torch.ops.kernels import _build
    from image_segmentation_tpu_torch.ops.kernels import mlp as K4

    counts = _build.launch_counts()
    assert {("mlp", "LAUNCHES"), ("mlp", "MANY_TOKEN_LAUNCHES")} <= set(counts)
    torch.manual_seed(0)
    model = torch.nn.Linear(3, 4)
    pair = _linear_pair(model)
    K4.LAUNCHES += 12
    K4.MANY_TOKEN_LAUNCHES += 12
    pair.launched = _build.launches_since(counts)  # what a capture of that forward records
    K4.LAUNCHES -= 12
    K4.MANY_TOKEN_LAUNCHES -= 12
    assert pair.launched == {("mlp", "LAUNCHES"): 12, ("mlp", "MANY_TOKEN_LAUNCHES"): 12}
    pair.begin_step()
    for _ in range(8):
        pair.forward(model, (torch.randn(2, 3),)).sum().backward()
    assert _build.launches_since(counts) == {("mlp", "LAUNCHES"): 96,
                                             ("mlp", "MANY_TOKEN_LAUNCHES"): 96}


def test_a_gradient_kept_across_steps_is_not_zeroed_under_it():
    """A parameter the optimizer does not clear keeps its `.grad`: the next
    step's zeroing of the buffers hands it a copy first, and the new step's
    gradients add to it."""
    torch.manual_seed(0)
    model = torch.nn.Linear(3, 4)
    pair = _linear_pair(model)
    x = torch.randn(2, 3)
    totals = []
    for _ in range(2):
        pair.begin_step()
        pair.forward(model, (x,)).sum().backward()
        pair.hand_grads()
        totals.append(model.bias.grad.clone())
    torch.testing.assert_close(totals[1], 2 * totals[0])
    assert model.bias.grad is not pair.bufs[1]


def test_a_pre_hook_that_changes_the_shape_runs_that_micro_batch_eagerly():
    torch.manual_seed(0)
    model = torch.nn.Linear(3, 4)
    pair = _linear_pair(model)
    model.register_forward_pre_hook(lambda m, a: (torch.cat([a[0], a[0]]),))
    pair.begin_step()
    with profiling.record_spans() as log:
        out = pair.forward(model, (torch.randn(2, 3),))
    out.sum().backward()
    pair.hand_grads()
    assert out.shape == (4, 4) and _counts(log) == (0, 0, 1)
    assert model.bias.grad is not pair.bufs[1]
    torch.testing.assert_close(model.bias.grad, torch.full((4,), 4.0))


def test_clip_resize_matrices_made_under_inference_mode_serve_a_train_step():
    """The ClipUNet's resize matrices are made once a shape; one first made
    by an inference-mode call is still one autograd may save."""
    from image_segmentation_tpu_torch.models.clip_unet import resize_linear

    x = torch.rand(1, 2, 3, 5)
    with torch.inference_mode():
        want = resize_linear(x, (7, 9))
    x.requires_grad_()
    got = resize_linear(x, (7, 9))
    got.sum().backward()
    torch.testing.assert_close(got.detach(), want)
    assert x.grad is not None and x.grad.shape == x.shape


# On the card.


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    torch.backends.cudnn.deterministic = before


def _keep_eager(state):
    """Give the state's model a no-op forward hook on a submodule, which a
    replay would skip: the state then steps eagerly."""
    next(state.model.children()).register_forward_hook(lambda m, a, o: None)
    return state


def _unet_twins(cuda):
    """A graphed and an eager UNet state (base 8, bf16) with the same weights."""
    return (_unet_state(cuda, base=8, dtype=torch.bfloat16),
            _keep_eager(_unet_state(cuda, base=8, dtype=torch.bfloat16)))


def _stepper(state, loss_fn, accum):
    """step(x, y) -> (micro-batch losses, counts) for one train_step."""
    def step(x, y):
        losses = []

        def recorded(out, t):
            loss = loss_fn(out, t)
            losses.append(loss.detach().float())
            return loss

        with profiling.record_spans() as log:
            train_step(state, recorded, x, y, accum_steps=accum)
        torch.cuda.synchronize()
        return torch.stack(losses), _counts(log)
    return step


def _stats(model):
    return {n: b.detach().clone() for n, b in model.named_buffers()}


def _close_dicts(got, want, rel=REL):
    assert got.keys() == want.keys()
    for k in want:
        g, w = got[k].float(), want[k].float()
        err = (g - w).norm().item()
        assert err <= rel * w.norm().item() + 1e-12, (k, err, w.norm().item())


@pytest.mark.cuda
def test_graphed_unet_steps_match_the_eager_steps(cuda):
    """UNet base 8, bf16, micro 2 x accum 4, three steps, graphed against an
    eager twin on the same weights and rows: the micro-batch losses, each
    leaf's .grad after step 1, the running statistics right after the
    capturing call, and the parameters and statistics after step 3."""
    g, e = _unet_twins(cuda)
    loss_fn = DiceCELoss()
    steps = _stepper(g, loss_fn, 4), _stepper(e, loss_fn, 4)
    batches = [_rows(8, side=64, seed=s, device=cuda) for s in range(3)]
    for s, (x, y) in enumerate(batches):
        (lg, cg), (le, ce) = (step(x, y) for step in steps)
        assert cg == ((1 if s == 0 else 0), 4, 0) and ce == (0, 0, 4)
        torch.testing.assert_close(lg, le, rtol=REL, atol=0)
        if s == 0:
            _close_dicts({n: p.grad for n, p in g.model.named_parameters()},
                         {n: p.grad for n, p in e.model.named_parameters()})
            _close_dicts(_stats(g.model), _stats(e.model))
    _close_dicts(dict(g.model.named_parameters()), dict(e.model.named_parameters()))
    _close_dicts(_stats(g.model), _stats(e.model))
    assert g.step == e.step == 3 and len(g.graphs.pairs) == 1


@pytest.mark.cuda
def test_capture_leaves_no_trace_on_the_state(cuda):
    """The capturing call's state (statistics, parameters, optimizer
    moments, step) equals an eager twin's after its one step."""
    g, e = _unet_twins(cuda)
    x, y = _rows(8, side=64, device=cuda)
    for st in (g, e):
        train_step(st, DiceCELoss(), x, y, accum_steps=4)
    torch.cuda.synchronize()
    _close_dicts(_stats(g.model), _stats(e.model))
    _close_dicts(dict(g.model.named_parameters()), dict(e.model.named_parameters()))
    moments = lambda st: {f"{i}.{k}": v for i, p in enumerate(st.optimizer.param_groups[0]["params"])  # noqa: E731
                          for k, v in st.optimizer.state[p].items() if k != "step"}
    _close_dicts(moments(g), moments(e))
    assert g.step == e.step == 1


@pytest.mark.cuda
def test_each_shape_captures_its_own_pair_up_to_the_bound(cuda, monkeypatch):
    """Micro-batches of 2, then 4, then 2 again replay their own pairs; with
    the bound at 2 a third shape runs eagerly. Every step's losses are the
    eager twin's."""
    g, e = _unet_twins(cuda)
    steps = _stepper(g, DiceCELoss(), 2), _stepper(e, DiceCELoss(), 2)
    x, y = _rows(8, side=64, device=cuda)
    monkeypatch.setattr(G, "MAX_SHAPES", 2)
    for rows, want in ((4, (1, 2, 0)), (8, (1, 2, 0)), (4, (0, 2, 0)), (6, (0, 0, 2)),
                       (4, (0, 2, 0))):
        (lg, cg), (le, _) = (step(x[:rows], y[:rows]) for step in steps)
        assert cg == want, (rows, cg)
        torch.testing.assert_close(lg, le, rtol=REL, atol=0)
    assert len(g.graphs.pairs) == 2


def _twin_steps(g, e, seed, rows=4):
    """One step of the graphed state and of its eager twin on the same rows:
    the graphed step's counts; their losses agree."""
    x, y = _rows(rows, side=64, seed=seed, device=g.model.output.weight.device)
    (lg, cg), (le, _) = (_stepper(st, DiceCELoss(), 2)(x, y) for st in (g, e))
    torch.testing.assert_close(lg, le, rtol=REL, atol=0)
    return cg


@pytest.mark.cuda
def test_graph_memory_is_counted_and_bounded(cuda, monkeypatch):
    """The pairs' memory is counted while they live and given back with
    them; a hook on a submodule drops a state's pairs; a pair that would
    pass `MEMORY_SHARE` is dropped and its shape runs eagerly. Every step's
    losses are the eager twin's."""
    import gc

    dev = torch.device("cuda", torch.cuda.current_device())
    gc.collect()
    assert G._MEMORY.held[dev] == 0
    (a, ea), (b, eb) = _unet_twins(cuda), _unet_twins(cuda)
    assert _twin_steps(a, ea, 0) == (1, 2, 0)
    one = G._MEMORY.held[dev]
    assert one > 0
    assert _twin_steps(b, eb, 1) == (1, 2, 0) and G._MEMORY.held[dev] > one
    h = b.model.down1.register_forward_hook(lambda m, a_, o: None)
    assert _twin_steps(b, eb, 2) == (0, 0, 2) and not b.graphs.pairs
    gc.collect()
    assert G._MEMORY.held[dev] == one
    h.remove()
    total = torch.cuda.get_device_properties(dev).total_memory
    monkeypatch.setattr(G, "MEMORY_SHARE", (one + one // 2) / total)
    assert _twin_steps(b, eb, 3) == (0, 0, 2) and list(b.graphs.pairs.values()) == [None]
    assert _twin_steps(b, eb, 4) == (0, 0, 2) and G._MEMORY.held[dev] == one
    assert _twin_steps(a, ea, 5) == (0, 2, 0)
    del a
    gc.collect()
    assert G._MEMORY.held[dev] == 0


@pytest.mark.cuda
def test_load_state_dict_between_steps_is_honoured_by_the_next_replay(cuda):
    """As the benchmark's `unchanged` fault does: the state put back after a
    step is what the next replay reads, weights and statistics both."""
    st = _unet_state(cuda, base=8, dtype=torch.bfloat16)
    step = _stepper(st, DiceCELoss(), 2)
    b1, b2 = _rows(4, side=64, seed=1, device=cuda), _rows(4, side=64, seed=2, device=cuda)
    step(*b1)
    keep = {k: v.detach().clone() for k, v in st.model.state_dict().items()}
    first, _ = step(*b2)
    after = _stats(st.model)
    st.model.load_state_dict(keep)
    again, counts = step(*b2)
    assert counts == (0, 2, 0)
    assert torch.equal(first, again)
    _close_dicts(_stats(st.model), after, rel=0.0)


def _clip_state(cuda, cfg, **extra):
    """A reduced model of a CLIP config as build_model builds it on CUDA
    (bf16, K3/K4 on), its ViT frozen out of AdamW as run.py freezes it."""
    from image_segmentation_tpu_torch import config as C
    from image_segmentation_tpu_torch.serve.app import DEMO_VIT
    from image_segmentation_tpu_torch.train.state import freeze_

    kw = dict(vit=DEMO_VIT, skip_indices=(0, 1, 2, 3), decoder_channels=(64, 32, 16, 8, 8),
              **extra)
    model = C.build_model(dataclasses.replace(cfg, use_kernels=True), cuda,
                          torch.Generator().manual_seed(0), **kw)
    frozen = ("clip.vision_model",) if cfg.model == "prompt" else ("vision_model",)
    freeze_(model, frozen)
    return TrainState(model, *C.build_optimizer(cfg, model, frozen_prefixes=frozen))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["clipunet", "prompt"])
def test_clip_models_are_graphed_and_count_their_kernel_launches(cuda, name):
    """The ClipUNet (frozen ViT on K3/K4) and the prompt model (two inputs)
    replay graphs: losses and gradients as the eager twin's, and K3/K4
    counted once a block and micro-batch, as eager counts them."""
    from image_segmentation_tpu_torch import config as C
    from image_segmentation_tpu_torch.ops.kernels import attention as K3
    from image_segmentation_tpu_torch.ops.kernels import mlp as K4

    cfg, extra = {"clipunet": (C.CLIPUNET, {}), "prompt": (C.PROMPT, {"unet_base": 8})}[name]
    g, e = _clip_state(cuda, cfg, **extra), _keep_eager(_clip_state(cuda, cfg, **extra))
    loss_fn = C.build_loss(cfg)
    x, y = _rows(8, side=64, device=cuda)
    hm = torch.rand(8, 64, 64, 1, generator=torch.Generator().manual_seed(3)).to(cuda)
    inputs = (x, hm) if name == "prompt" else x
    blocks = g.model.clip.vit.num_layers if name == "prompt" else g.model.vit.num_layers
    for s in range(2):
        launched = []
        for st, want in ((g, ((1 if s == 0 else 0), 2, 0)), (e, (0, 0, 2))):
            before = K3.LAUNCHES, K4.LAUNCHES
            losses, counts = _stepper(st, loss_fn, 2)(inputs, y)
            assert counts == want
            launched.append((K3.LAUNCHES - before[0], K4.LAUNCHES - before[1]))
            if st is g:
                lg = losses
        assert launched == [(2 * blocks, 2 * blocks)] * 2
        torch.testing.assert_close(lg, losses, rtol=REL, atol=0)
    _close_dicts({n: p.grad for n, p in g.model.named_parameters() if p.grad is not None},
                 {n: p.grad for n, p in e.model.named_parameters() if p.grad is not None})


from torch_spawn import spawn  # noqa: E402

if __name__ == "__main__":
    from torch_spawn import child_main

    child_main({"w_group": w_group})
