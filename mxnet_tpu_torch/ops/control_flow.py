"""Control-flow ops over subgraphs (port of ``mxnet_tpu/ops/control_flow.py``):
``_foreach``, ``_while_loop``, ``_cond`` and ``_subgraph_exec``.

A subgraph is a Symbol held as an op parameter; its evaluation function
is ``executor._build_eval``.  The loops are Python loops over the body's
ops, which run eagerly or, inside a step captured as a CUDA graph, under
that capture.  Nothing here reads a device value on the host, so every
op can be captured:

- ``_while_loop`` runs all ``max_iterations`` steps with a mask, as the
  reference's masked scan does: rows of steps not executed are zeros,
  and the loop variables stop changing once ``cond`` turns false.
- ``_cond`` runs both branches and selects each output with
  ``torch.where`` on the device predicate.  Each branch's array inputs
  pass through a gate whose backward keeps the gradient where the branch
  was taken and puts zeros elsewhere, so the branch not taken adds
  nothing to a gradient, not even a NaN from an infinite derivative
  (``log(x)`` at 0), and the gradient is ``lax.cond``'s.
"""

from __future__ import annotations

import torch

from .registry import register_op

__all__ = []


def _subgraph_eval(subgraph, training):
    from ..executor import _build_eval
    return _build_eval(subgraph, training)


@register_op("_foreach", needs_rng=True, input_names=(),
             num_outputs=lambda p: int(p["n_outputs"]) + int(p["n_states"]))
def _foreach_op(rng, *arrays, subgraph=None, n_data=1, n_states=0,
                n_outputs=1, data_names=(), state_names=(),
                closure_names=(), training=True):
    """arrays = data (scanned on axis 0) + init states + closure values.
    The subgraph's outputs are [outputs..., new_states...], its inputs
    bound by name to the step's slices, the states and the closure.
    Returns (*stacked_outputs, *final_states)."""
    n_data, n_states, n_outputs = int(n_data), int(n_states), int(n_outputs)
    data = arrays[:n_data]
    states = list(arrays[n_data:n_data + n_states])
    closure = dict(zip(closure_names, arrays[n_data + n_states:]))
    eval_fn = _subgraph_eval(subgraph, training)
    ys = []
    for t in range(data[0].shape[0]):
        amap = dict(zip(data_names, [d[t] for d in data]))
        amap.update(zip(state_names, states))
        amap.update(closure)
        outs, _ = eval_fn(amap, {}, rng)
        states = outs[n_outputs:]
        ys.append(outs[:n_outputs])
    stacked = [torch.stack(list(col)) for col in zip(*ys)]
    return tuple(stacked) + tuple(states)


@register_op("_while_loop", needs_rng=True, input_names=(),
             num_outputs=lambda p: int(p["n_outputs"]) +
             int(p["n_loop_vars"]))
def _while_loop_op(rng, *arrays, cond_graph=None, func_graph=None,
                   max_iterations=0, n_loop_vars=1, n_outputs=1,
                   loop_var_names=(), cond_closure_names=(),
                   func_closure_names=(), training=True):
    """arrays = loop vars + cond closure + func closure.  Runs ``func``
    while ``cond`` holds, bounded by *max_iterations*, as a masked loop
    of exactly *max_iterations* steps.  Returns (*stacked_outputs,
    *final_loop_vars); output rows past the executed steps are zeros."""
    n_loop_vars, n_outputs = int(n_loop_vars), int(n_outputs)
    lnames = loop_var_names
    states = list(arrays[:n_loop_vars])
    ncc = len(cond_closure_names)
    cond_clo = dict(zip(cond_closure_names,
                        arrays[n_loop_vars:n_loop_vars + ncc]))
    func_clo = dict(zip(func_closure_names, arrays[n_loop_vars + ncc:]))
    cond_fn = _subgraph_eval(cond_graph, training)
    func_fn = _subgraph_eval(func_graph, training)
    done = torch.zeros((), dtype=torch.bool, device=states[0].device)
    ys = []
    for _ in range(int(max_iterations)):
        amap = dict(zip(lnames, states))
        amap.update(cond_clo)
        pred = (cond_fn(amap, {}, rng)[0][0] != 0).reshape(())
        active = torch.logical_and(torch.logical_not(done), pred)
        amap = dict(zip(lnames, states))
        amap.update(func_clo)
        outs, _ = func_fn(amap, {}, rng)
        states = [torch.where(active, n, s)
                  for n, s in zip(outs[n_outputs:], states)]
        ys.append([torch.where(active, o, torch.zeros_like(o))
                   for o in outs[:n_outputs]])
        done = torch.logical_not(active)
    stacked = [torch.stack(list(col)) for col in zip(*ys)]
    return tuple(stacked) + tuple(states)


class _BranchGate(torch.autograd.Function):
    """The identity forward; backward passes the gradient where *taken*
    and zeros elsewhere (selected, so a NaN where not taken is dropped)."""

    @staticmethod
    def forward(ctx, x, taken):
        ctx.save_for_backward(taken)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        taken, = ctx.saved_tensors
        return torch.where(taken, grad, torch.zeros_like(grad)), None


def _gated(inputs, taken):
    return {n: _BranchGate.apply(v, taken)
            if torch.is_grad_enabled() and v.requires_grad else v
            for n, v in inputs.items()}


@register_op("_cond", needs_rng=True, input_names=(),
             num_outputs=lambda p: int(p["n_outputs"]))
def _cond_op(rng, *arrays, pred_graph=None, then_graph=None,
             else_graph=None, n_outputs=1, pred_names=(), then_names=(),
             else_names=(), training=True):
    """arrays = pred inputs + then inputs + else inputs (by the name
    lists).  Both branches run; each output is the then branch's where
    the predicate holds, else the else branch's (see the module
    docstring for the gradient).  The branches must give the same output
    spec."""
    n_outputs = int(n_outputs)
    np_, nt = len(pred_names), len(then_names)
    pred_in = dict(zip(pred_names, arrays[:np_]))
    then_in = dict(zip(then_names, arrays[np_:np_ + nt]))
    else_in = dict(zip(else_names, arrays[np_ + nt:]))
    pred_fn = _subgraph_eval(pred_graph, training)
    then_fn = _subgraph_eval(then_graph, training)
    else_fn = _subgraph_eval(else_graph, training)
    pred = (pred_fn(pred_in, {}, rng)[0][0] != 0).reshape(())
    t_out = then_fn(_gated(then_in, pred), {}, rng)[0][:n_outputs]
    e_out = else_fn(_gated(else_in, torch.logical_not(pred)), {},
                    rng)[0][:n_outputs]
    return tuple(torch.where(pred, t, e) for t, e in zip(t_out, e_out))


@register_op("_subgraph_exec", needs_rng=True, input_names=(),
             num_outputs=lambda p: int(p["n_outputs"]))
def _subgraph_exec_op(rng, *inputs, subgraph=None, input_names=(),
                      n_outputs=1, training=False):
    """Run a captured sub-Symbol as one unit, its placeholder variables
    bound to *inputs* by name."""
    eval_fn = _subgraph_eval(subgraph, training)
    outs, _ = eval_fn(dict(zip(input_names, inputs)), {}, rng)
    return tuple(outs)
