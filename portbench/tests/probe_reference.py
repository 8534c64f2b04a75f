"""A reference module for the tests, which a configuration written by a
test names (its ``"reference": "probe"``, this file copied to
``reference/probe.py``): each layer call records where it sat (``at``),
the stack's input it was handed (``x0``) and its residual input, then
gives `ops`' result.  The rest of the contract is `ops`' own."""
from portbench.reference import ops
from portbench.reference.ops import (embed, logits, loss,  # noqa: F401
                                     model_flops, param_count)

CALLS = []          # (at, x0, x) of every layer call, in order


def layer(at, params, x, x0, m, prec, *, moe_in=None, act_dtype=None):
    CALLS.append((at, x0, x))
    return ops.layer(at, params, x, x0, m, prec, moe_in=moe_in,
                     act_dtype=act_dtype)
