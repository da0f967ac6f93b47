"""A kernel's forward with its plain version's gradient.

The JAX package wraps its eval kernels (K1, K3, K12, K15, K16) in
``jax.custom_vjp`` with a backward that recomputes through the XLA
reference.  ``with_plain_grad`` does the same for a kernel of the port:
the forward runs the kernel, the backward runs the plain version again
under autograd and returns its gradients.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


class _PlainGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernel, plain, *tensors):
        ctx.plain = plain
        ctx.save_for_backward(*tensors)
        return kernel(*tensors)

    @staticmethod
    def backward(ctx, grad):
        wanted = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            inputs = [None if a is None else a.detach().requires_grad_(w)
                      for a, w in zip(ctx.saved_tensors, wanted)]
            out = ctx.plain(*inputs)
            grads = iter(torch.autograd.grad(
                out, [a for a, w in zip(inputs, wanted) if w], grad,
                allow_unused=True))
        return (None, None, *(next(grads) if w else None for w in wanted))


def with_plain_grad(kernel: Callable, plain: Callable,
                    *tensors: Optional[torch.Tensor]) -> torch.Tensor:
    """``kernel(*tensors)``, with the gradient of ``plain(*tensors)``
    with respect to each tensor that requires one.  ``plain`` computes
    the same function as ``kernel``; integer tensors (lengths) and None
    pass through without a gradient.  A call that autograd would not
    record (serving, ``torch.no_grad``) runs the kernel alone."""
    if not torch.is_grad_enabled() or not any(
            a is not None and a.requires_grad for a in tensors):
        return kernel(*tensors)
    return _PlainGrad.apply(kernel, plain, *tensors)
