"""The training path's BatchNorm + ReLU op (``nn/layers.py::batch_norm_relu``,
``ops/batchnorm_kernel.py``) on the CPU, where it runs the plain version of
each of its four kernels, against ``relu(batch_norm(x, bn, train=True))``
and its autograd: the output, the running statistics (flax's momentum,
biased variance) and the gradients of x, γ and β in f32 within a few ulps
of their largest (the op sums in f64 and rounds once, the chain sums in
f32), ``gradcheck`` in f64, and a constant column, where the clamp holds
the variance at 0. The
kernels themselves are held to these plain versions on the card
(``tests/test_torch_cuda.py``); the global batch over gloo ranks in
``tests/test_torch_parallel.py``.
"""

import copy

import pytest
import torch
from torch import nn

from pointvit_tpu_torch import _build
from pointvit_tpu_torch.nn.layers import batch_norm, batch_norm_relu, update_running_stats
from pointvit_tpu_torch.ops import batchnorm_kernel

# (name, shape of x): P3-like (B, S, K, C) groups at two widths, a head's (B, C).
SHAPES = [("p3_32", (2, 4, 16, 32)), ("p3_64", (2, 4, 16, 64)), ("head_16", (64, 16))]
REL_TOL = 1e-5  # the chain's f32 sums over 128 rows against the op's f64 ones: a few ulps


def _inputs(shape, seed, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    C = shape[-1]
    scale, offset = 0.5 + torch.rand(C, generator=gen), torch.randn(C, generator=gen)
    x = torch.randn(shape, generator=gen) * scale + offset
    x[..., 1] = 3.0  # a constant column: var is 0 and held there by the clamp
    bn = nn.BatchNorm1d(C, eps=1e-5, momentum=0.1)
    with torch.no_grad():
        bn.weight.copy_(1.0 + 0.3 * torch.randn(C, generator=gen))
        bn.bias.copy_(0.2 * torch.randn(C, generator=gen))
        bn.running_mean.copy_(torch.randn(C, generator=gen))
        bn.running_var.copy_(0.5 + torch.rand(C, generator=gen))
    w = torch.randn(shape, generator=gen)  # the loss's weights: sum(y · w)
    return x.to(dtype), bn.to(dtype), w.to(dtype)


def _run(op, x, bn, w, deferred):
    """The op's output, the gradients of x, γ and β, and bn's running
    statistics after the op (and after the deferred update, if any)."""
    x = x.clone().requires_grad_()
    updates = [] if deferred else None
    y = op(x, bn, updates)
    (y * w).sum().backward()
    if deferred:
        assert len(updates) == 1 and not any(t.requires_grad for t in updates[0][1:])
        assert updates[0][0] is bn
        update_running_stats(updates)
    return y.detach(), x.grad, bn.weight.grad, bn.bias.grad, bn.running_mean.clone(), bn.running_var.clone()


def _chain(x, bn, deferred):
    return torch.relu(batch_norm(x, bn, train=True, deferred=deferred))


def _op(x, bn, deferred):
    return batch_norm_relu(x, bn, train=True, deferred=deferred)


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.parametrize("deferred", [False, True], ids=["applied", "deferred"])
@pytest.mark.parametrize("name,shape", SHAPES, ids=[n for n, _ in SHAPES])
def test_batch_norm_relu_is_the_train_mode_chain_and_its_gradient(name, shape, deferred):
    x, bn, w = _inputs(shape, len(name) + len(shape))
    bn_op = copy.deepcopy(bn)
    before = (bn.running_mean.clone(), bn.running_var.clone())
    _build.reset_launch_counts()
    want = _run(_chain, x, bn, w, deferred)
    got = _run(_op, x, bn_op, w, deferred)
    assert not any(_build.launch_counts().values())  # the CPU runs the plain versions

    y, dx, dgamma, dbeta, rmean, rvar = got
    for got_t, want_t in zip(got, want):
        assert _rel(got_t, want_t) <= REL_TOL
    C = shape[-1]
    flat = x.reshape(-1, C).double()
    mean, var = flat.mean(0), flat.var(0, unbiased=False)
    torch.testing.assert_close(rmean.double(), 0.9 * before[0].double() + 0.1 * mean, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(rvar.double(), 0.9 * before[1].double() + 0.1 * var, rtol=1e-5, atol=1e-6)
    assert var[1] == 0 and rvar[1] == pytest.approx(0.9 * before[1][1].item())
    # The constant column: x̂ = 0 there, so only dy's own term and its mean remain.
    assert dgamma[1].abs() <= REL_TOL * dgamma.abs().max()

    # gradcheck of the op in f64 through x, γ and β (gradcheck perturbs the
    # tensors it is given in place, bn64's own parameters among them; the
    # running statistics move on every call, which the gradient does not see)
    x64, bn64, _ = _inputs(shape[-2:] if len(shape) > 2 else shape, 7, torch.float64)
    fn = lambda t, g, b: batch_norm_relu(t, bn64, train=True, deferred=[] if deferred else None)  # noqa: E731
    assert torch.autograd.gradcheck(fn, (x64.requires_grad_(), bn64.weight, bn64.bias), eps=1e-6,
                                    atol=1e-5, rtol=1e-4)


def test_batch_norm_relu_keeps_the_chain_off_its_gate_and_at_inference():
    """A width that is not a multiple of 8 keeps relu(batch_norm(...)), and
    so does inference, bit for bit; the kernels' entry refuses such a width
    on the card's path."""
    for shape, train in (((64, 12), True), ((64, 16), False)):
        x, bn, _ = _inputs(shape, 3)
        bn_op = copy.deepcopy(bn)
        assert torch.equal(batch_norm_relu(x, bn_op, train=train), _chain_eval(x, bn, train))
        assert torch.equal(bn_op.running_var, bn.running_var)
    with pytest.raises(ValueError, match="multiple of 8"):
        batchnorm_kernel.train_batch_norm_relu(torch.randn(4, 12), torch.ones(12), torch.zeros(12), 1e-5)


def _chain_eval(x, bn, train):
    return torch.relu(batch_norm(x, bn, train=train))
