"""Gated weight gradients for frozen blocks (port of the JAX package's
``core/gated.py``).

Under ``ModelConfig.gate_weight_grads`` the step chooses its block mask
before the backward, from the policy's cumulative signal
(``methods/selection.py``), and a frozen layer's weight gradients are never
computed. The reference cannot leave work out of its one compiled program,
so it wraps each block in a custom VJP whose ``lax.cond`` skips the dW
branch at run time. Eager PyTorch decides each launch on the host: a frozen
layer's parameters reach its block detached, so autograd records no edge
to them, and the backward launches only the products that carry the
activation gradient (which the selected layers before it need). Its dW
products, its bias reductions and its RMSNorm scale sums are never
launched; the RMSNorm backward runs its dx-only mode
(``layers/norms.py``). The frozen rows of each stacked gradient come out
exactly zero, as the reference's ``dparams_zero`` gives them: the backward
of the ``unbind`` that splits the stacked leaf fills the rows it got no
gradient for.
"""
from __future__ import annotations


def gate_layer(params: dict, selected: bool) -> dict:
    """One layer's parameter dict as its block should see it: unchanged for
    a selected layer, every leaf ``.detach()``ed for a frozen one.
    ``selected`` is a host bool: reading it launches nothing."""
    if selected:
        return params
    return {k: (gate_layer(v, False) if isinstance(v, dict) else v.detach())
            for k, v in params.items()}
