"""Fused bias + activation + gain + clamp
(counterpart: latentaugment_tpu/ops/bias_act.py).

y = clamp(gain * act(x + b[c]), +-clamp), with the bias broadcast along
`dim`. Two implementations sit side by side:

  * `_bias_act_ref`: plain PyTorch; autograd gives its gradient. It runs
    for CPU tensors and for `impl='ref'`.
  * kernel K1, two Triton kernels (forward and backward), each launched
    by a registered custom op (`latentaugment_torch::bias_act_fwd` /
    `::bias_act_bwd`): behind `_BiasActFunction` when a gradient is
    needed, called directly otherwise. The backward is a Function of its
    own (`_BiasActGradFunction`), so the rectifiers' second derivatives
    launch the backward kernel again. It runs for every CUDA tensor unless
    `impl='ref'`; there is no fallback on the card.

K1 replaces the Pallas kernel `_bias_act_pallas`
(latentaugment_tpu/ops/bias_act.py:95-139), which has no backward kernel
(JAX autodiff differentiates the XLA path). On the H100 the op is bound
by memory traffic: per element the forward reads x and writes y (2 + 2
bytes in bf16), the backward reads dy and the saved y (and x for the
smooth activations) and writes dx, with no reuse and no tensor-core
work. The design moves each byte once: one flat pass over the
contiguous tensor, 1024 elements per program, the channel of each
element computed from its flat offset (so no transpose to a
[rows, C] view as the TPU kernel did), math in fp32, stores in the
input dtype. Following NVIDIA's bias_act convention the backward reads
the saved output y for the rectifiers and for the clamp mask
(dx = dy * gain * act'(x + b) * [|y| < clamp]) and does not recompute
the clamp.
"""

import functools
import importlib
import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..utils.util_easydict import EasyDict
from . import _build

_SQRT2 = 1.4142135623730951

# `idx` is the activation's id inside the Triton kernels.
activation_funcs = {
    'linear':   EasyDict(func=lambda x, a: x,                      def_alpha=0.0, def_gain=1.0,    idx=0),
    'relu':     EasyDict(func=lambda x, a: F.relu(x),              def_alpha=0.0, def_gain=_SQRT2, idx=1),
    'lrelu':    EasyDict(func=lambda x, a: F.leaky_relu(x, a),     def_alpha=0.2, def_gain=_SQRT2, idx=2),
    'tanh':     EasyDict(func=lambda x, a: torch.tanh(x),          def_alpha=0.0, def_gain=1.0,    idx=3),
    'sigmoid':  EasyDict(func=lambda x, a: torch.sigmoid(x),       def_alpha=0.0, def_gain=1.0,    idx=4),
    'elu':      EasyDict(func=lambda x, a: F.elu(x),               def_alpha=0.0, def_gain=1.0,    idx=5),
    'selu':     EasyDict(func=lambda x, a: F.selu(x),              def_alpha=0.0, def_gain=1.0,    idx=6),
    'softplus': EasyDict(func=lambda x, a: F.softplus(x),          def_alpha=0.0, def_gain=1.0,    idx=7),
    'swish':    EasyDict(func=lambda x, a: x * torch.sigmoid(x),   def_alpha=0.0, def_gain=_SQRT2, idx=8),
}

# The backward of these reads only the saved output y; the others also
# need the pre-activation x + b.
_ACTS_FROM_Y = ('linear', 'relu', 'lrelu')

# Launches of each Triton kernel, counted where they are launched; the
# backward kernel's launches for a second derivative count apart.
launches = {'bias_act_fwd': 0, 'bias_act_bwd': 0, 'bias_act_bwd2': 0}


def bias_act(x, b=None, dim=1, act='linear', alpha=None, gain=None, clamp=None,
             impl='auto'):
    """y = clamp(gain * act(x + reshape(b)), +-clamp).

    Args:
      x: input of any shape.
      b: optional bias of shape [x.shape[dim]].
      dim: dimension of x that the bias broadcasts along.
      act: activation name from `activation_funcs`.
      alpha: activation shape parameter (lrelu slope); None -> default.
      gain: output scale; None -> activation's default gain.
      clamp: clamp output to [-clamp, +clamp] if >= 0.
      impl: 'auto' (kernel K1 on CUDA tensors, plain PyTorch on CPU
        tensors) or 'ref' (plain PyTorch everywhere).
    """
    spec = activation_funcs[act]
    alpha = float(alpha if alpha is not None else spec.def_alpha)
    gain = float(gain if gain is not None else spec.def_gain)
    clamp = float(clamp if clamp is not None else -1.0)
    if not (clamp >= 0 or clamp == -1.0):
        raise ValueError(f"clamp must be >= 0 or None, got {clamp}")
    if b is not None and (b.ndim != 1 or b.shape[0] != x.shape[dim]):
        raise ValueError(f"bias shape {tuple(b.shape)} does not match "
                         f"x.shape[{dim}] = {x.shape[dim]}")
    if impl not in ('auto', 'ref'):
        raise ValueError(f"impl must be 'auto' or 'ref', got {impl!r}")
    if impl == 'ref' or x.device.type == 'cpu':
        return _bias_act_ref(x, b, dim, act, alpha, gain, clamp)
    if x.device.type != 'cuda':
        raise NotImplementedError(f"bias_act has no kernel for {x.device}")
    dim = dim % x.ndim
    if torch.is_grad_enabled() and (x.requires_grad or (b is not None and b.requires_grad)):
        return _BiasActFunction.apply(x, b, dim, act, alpha, gain, clamp)
    return torch.ops.latentaugment_torch.bias_act_fwd(x, b, dim, act, alpha, gain, clamp)


def _bias_act_ref(x, b, dim, act, alpha, gain, clamp):
    if b is not None:
        shape = [1] * x.ndim
        shape[dim] = -1
        x = x + b.reshape(shape)
    x = activation_funcs[act].func(x, alpha)
    if gain != 1.0:
        x = x * gain
    if clamp >= 0:
        x = x.clamp(-clamp, clamp)
    return x


# ----------------------------------------------------------------------------
# Kernel K1 (Triton), launched only through the registered custom ops
# `latentaugment_torch::bias_act_fwd` and `::bias_act_bwd`, so that
# `torch.export` records the launches as ops of the program (the Triton
# launch inside is opaque to it). Their fake versions give the output's
# shape and dtype only. They have no CPU kernel: a CPU tensor raises.

def _bias_act_fwd_impl(x: torch.Tensor, b: Optional[torch.Tensor], dim: int, act: str,
                       alpha: float, gain: float, clamp: float) -> torch.Tensor:
    x = x.contiguous()
    y = torch.empty_like(x)
    _launch_fwd(x, b.contiguous() if b is not None else None, y, dim, act, alpha, gain, clamp)
    return y


def _bias_act_bwd_impl(dy: torch.Tensor, x: Optional[torch.Tensor], b: Optional[torch.Tensor],
                       y: torch.Tensor, dim: int, act: str, alpha: float, gain: float,
                       clamp: float, counter: str) -> torch.Tensor:
    y = y.contiguous()
    dx = torch.empty_like(y)
    _launch_bwd(dy.contiguous(), x if x is None else x.contiguous(),
                b if b is None else b.contiguous(), y, dx, dim, act, alpha, gain, clamp,
                counter)
    return dx


_bias_act_fwd_op = torch.library.custom_op(
    "latentaugment_torch::bias_act_fwd", _bias_act_fwd_impl, mutates_args=(),
    device_types="cuda")
_bias_act_bwd_op = torch.library.custom_op(
    "latentaugment_torch::bias_act_bwd", _bias_act_bwd_impl, mutates_args=(),
    device_types="cuda")


@_bias_act_fwd_op.register_fake
def _(x, b, dim, act, alpha, gain, clamp):
    return x.new_empty(x.shape)


@_bias_act_bwd_op.register_fake
def _(dy, x, b, y, dim, act, alpha, gain, clamp, counter):
    return y.new_empty(y.shape)


class _BiasActFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, b, dim, act, alpha, gain, clamp):
        y = torch.ops.latentaugment_torch.bias_act_fwd(x, b, dim, act, alpha, gain, clamp)
        if act in _ACTS_FROM_Y:
            ctx.save_for_backward(None, None, y)
        else:
            ctx.save_for_backward(x, b, y)
        ctx.cfg = (dim, act, alpha, gain, clamp)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, b, y = ctx.saved_tensors
        dim, act = ctx.cfg[:2]
        if act in _ACTS_FROM_Y:
            # The rectifiers' dx depends on y only through masks that are
            # constant almost everywhere: detached, y opens no path along
            # which a second derivative would run this backward again on
            # zeros. (A smooth activation keeps x attached, so that its
            # second derivative reaches _BiasActGradFunction and raises.)
            y = y.detach()
        dx = _BiasActGradFunction.apply(dy, x, b, y, ctx.cfg, 'bias_act_bwd')
        db = None
        if ctx.needs_input_grad[1]:
            dims = [d for d in range(dx.ndim) if d != dim]
            db = dx.float().sum(dims).to(dx.dtype)
        return dx, db, None, None, None, None, None


class _BiasActGradFunction(torch.autograd.Function):
    """dx = the backward kernel on dy (NVIDIA's BiasActCudaGrad design).

    For linear, relu and lrelu, with or without clamp,
    dx = dy * gain * act'(x + b) * [|y| < clamp] is linear in dy, and its
    mask is piecewise constant in y: the derivative of dx with respect to
    dy is the same kernel applied to the incoming gradient, and the one
    with respect to x, b or y is zero. So second derivatives (R1,
    path-length regularisation) launch this kernel again, counted under
    `counter`. The smooth activations' dx is not linear in that way; their
    second derivative on the card raises."""

    @staticmethod
    def forward(ctx, dy, x, b, y, cfg, counter):
        dx = torch.ops.latentaugment_torch.bias_act_bwd(dy, x, b, y, *cfg, counter)
        ctx.save_for_backward(x, b, y)
        ctx.cfg = cfg
        return dx

    @staticmethod
    def backward(ctx, ddx):
        act = ctx.cfg[1]
        if act not in _ACTS_FROM_Y:
            raise NotImplementedError(
                f"kernel K1 has no second derivative for act={act!r} (only "
                f"{', '.join(_ACTS_FROM_Y)}); use impl='ref'")
        x, b, y = ctx.saved_tensors
        ddy = _BiasActGradFunction.apply(ddx, x, b, y, ctx.cfg, 'bias_act_bwd2')
        return ddy, None, None, None, None, None


def _geometry(x, dim):
    return x.numel(), x.shape[dim], math.prod(x.shape[dim + 1:])


_BLOCK = 1024


def _launch_fwd(x, b, y, dim, act, alpha, gain, clamp):
    triton, fwd, _ = _triton_kernels()
    n, c, inner = _geometry(x, dim)
    if n == 0:
        return
    with torch.cuda.device(x.device):
        fwd[(triton.cdiv(n, _BLOCK),)](
            x, b if b is not None else x, y, n, c, inner, alpha, gain, clamp,
            ACT=activation_funcs[act].idx, HAS_BIAS=b is not None,
            CLAMP=clamp >= 0, BLOCK=_BLOCK, num_warps=4)
    launches['bias_act_fwd'] += 1


def _launch_bwd(dy, x, b, y, dx, dim, act, alpha, gain, clamp, counter):
    triton, _, bwd = _triton_kernels()
    n, c, inner = _geometry(y, dim)
    if n == 0:
        return
    use_x = act not in _ACTS_FROM_Y
    with torch.cuda.device(y.device):
        bwd[(triton.cdiv(n, _BLOCK),)](
            dy, x if use_x else y, b if b is not None else y, y, dx,
            n, c, inner, alpha, gain, clamp,
            ACT=activation_funcs[act].idx, HAS_BIAS=use_x and b is not None,
            CLAMP=clamp >= 0, NEED_X=use_x,
            NEED_Y=act in ('relu', 'lrelu') or clamp >= 0,
            BLOCK=_BLOCK, num_warps=4)
    launches[counter] += 1


@functools.lru_cache(maxsize=None)
def _triton_kernels():
    """Import Triton and define the two kernels (first CUDA launch only).

    Triton resolves the names a kernel uses through the kernel's module
    globals, so `triton` and `tl` are bound there rather than as locals of
    this function (a closure variable would not resolve)."""
    _build.set_triton_cache_dir()
    globals()['triton'] = importlib.import_module('triton')
    globals()['tl'] = importlib.import_module('triton.language')

    @triton.jit
    def bias_act_fwd(x_ptr, b_ptr, y_ptr, n, C, inner, alpha, gain, clamp,
                     ACT: tl.constexpr, HAS_BIAS: tl.constexpr,
                     CLAMP: tl.constexpr, BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        v = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        if HAS_BIAS:
            c = (offs // inner) % C
            v += tl.load(b_ptr + c, mask=mask, other=0.0).to(tl.float32)
        if ACT == 0:
            r = v
        elif ACT == 1:
            r = tl.maximum(v, 0.0)
        elif ACT == 2:
            r = tl.where(v >= 0, v, v * alpha)
        elif ACT == 3:
            # tanh: Taylor series near 0 keeps the relative error small
            # where (1 - e) / (1 + e) would cancel.
            a = tl.abs(v)
            e = tl.exp(-2.0 * a)
            t = (1.0 - e) / (1.0 + e)
            a2 = a * a
            t_small = a * (1.0 + a2 * (-1.0 / 3.0 + a2 * (2.0 / 15.0 + a2 * (-17.0 / 315.0))))
            t = tl.where(a < 0.1, t_small, t)
            r = tl.where(v < 0, -t, t)
        elif ACT == 4:
            r = tl.sigmoid(v)
        elif ACT == 5:
            r = tl.where(v > 0, v, tl.exp(v) - 1.0)
        elif ACT == 6:
            r = 1.0507009873554804934193349852946 * tl.where(
                v > 0, v, 1.6732632423543772848170429916717 * (tl.exp(v) - 1.0))
        elif ACT == 7:
            r = tl.maximum(v, 0.0) + tl.log(1.0 + tl.exp(-tl.abs(v)))
        else:
            r = v * tl.sigmoid(v)
        r = r * gain
        if CLAMP:
            r = tl.minimum(tl.maximum(r, -clamp), clamp)
        tl.store(y_ptr + offs, r.to(y_ptr.dtype.element_ty), mask=mask)

    @triton.jit
    def bias_act_bwd(dy_ptr, x_ptr, b_ptr, y_ptr, dx_ptr, n, C, inner, alpha,
                     gain, clamp, ACT: tl.constexpr, HAS_BIAS: tl.constexpr,
                     CLAMP: tl.constexpr, NEED_X: tl.constexpr,
                     NEED_Y: tl.constexpr, BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        g = tl.load(dy_ptr + offs, mask=mask, other=0.0).to(tl.float32) * gain
        if NEED_Y:
            y = tl.load(y_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        if NEED_X:
            v = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            if HAS_BIAS:
                c = (offs // inner) % C
                v += tl.load(b_ptr + c, mask=mask, other=0.0).to(tl.float32)
        # The rectifiers read the sign of x + b from y; a negative gain
        # flips it (clamping keeps it).
        if ACT == 1:
            g = tl.where(y * gain > 0, g, 0.0)
        elif ACT == 2:
            g = tl.where(y * gain > 0, g, g * alpha)
        elif ACT == 3:
            e = tl.exp(-2.0 * tl.abs(v))
            t = (1.0 - e) / (1.0 + e)
            g = g * (1.0 - t * t)
        elif ACT == 4:
            s = tl.sigmoid(v)
            g = g * s * (1.0 - s)
        elif ACT == 5:
            g = tl.where(v > 0, g, g * tl.exp(v))
        elif ACT == 6:
            g = g * 1.0507009873554804934193349852946 * tl.where(
                v > 0, 1.0, 1.6732632423543772848170429916717 * tl.exp(v))
        elif ACT == 7:
            g = g * tl.sigmoid(v)
        elif ACT == 8:
            s = tl.sigmoid(v)
            g = g * (s + v * s * (1.0 - s))
        if CLAMP:
            g = tl.where(tl.abs(y) < clamp, g, 0.0)
        tl.store(dx_ptr + offs, g.to(dx_ptr.dtype.element_ty), mask=mask)

    return triton, bias_act_fwd, bias_act_bwd
