"""Graph evaluation (port of ``mxnet_tpu/executor.py``, subset:
``_build_eval``).

PyTorch runs eagerly, so evaluating a Symbol is a walk over its nodes in
topological order, calling each op on tensors.  Each intermediate value is
released after its last consumer has run, so peak memory follows the
graph's live set rather than its total size.
"""

from __future__ import annotations

from .base import MXNetError

__all__ = ["_build_eval"]


def _build_eval(symbol, training, op_impls=None):
    """Build ``fn(arg_map, aux_map, generator=None) -> (outputs,
    aux_updates)`` evaluating *symbol* over name -> tensor maps.

    *op_impls* ({op name: fn}) swaps an op's implementation for this
    evaluation only, e.g. to run a graph with the plain attention."""
    order = symbol._topo()
    out_entries = list(symbol._outputs)
    impls = dict(op_impls or {})
    keep = {(id(n), i) for n, i in out_entries}
    # position after which each value has no consumer left
    last_use = {}
    for pos, node in enumerate(order):
        for src, i in node.inputs:
            last_use[(id(src), i)] = pos
    release = {}
    for key, pos in last_use.items():
        if key not in keep:
            release.setdefault(pos, []).append(key)

    def fn(arg_map, aux_map, generator=None):
        vals = {}
        aux_updates = {}
        for pos, node in enumerate(order):
            if node.is_var:
                if node.name in arg_map:
                    vals[(id(node), 0)] = arg_map[node.name]
                elif node.name in aux_map:
                    vals[(id(node), 0)] = aux_map[node.name]
                else:
                    raise MXNetError("unbound variable %r" % node.name)
                continue
            op = node.op
            ins = [vals[(id(s), i)] for (s, i) in node.inputs]
            params = node.params
            if "training" in op.param_names:
                params = dict(params, training=training)
            impl = impls.get(op.name, op.fn)
            if op.needs_rng:
                out = impl(generator, *ins, **params)
            else:
                out = impl(*ins, **params)
            if not isinstance(out, tuple):
                out = (out,)
            for i, o in enumerate(out):
                vals[(id(node), i)] = o
            if training and op.aux_states:
                for in_idx, out_idx in op.aux_states.items():
                    src, _ = node.inputs[in_idx]
                    if src.is_var and src.name in aux_map:
                        aux_updates[src.name] = out[out_idx]
            for key in release.get(pos, ()):
                vals.pop(key, None)
        return [vals[(id(n), i)] for (n, i) in out_entries], aux_updates

    return fn
