"""Symbolic control flow (port of ``mxnet_tpu/symbol/contrib.py``):
``foreach``, ``while_loop``, ``cond`` and ``rand_zipfian``, beside the
``_contrib_*`` ops (``sym.contrib.DotProductAttention``) that
``symbol/__init__.py`` installs here.

The body, cond and func callables are traced once over placeholder
variables; the traced subgraph becomes a parameter of a ``_foreach``,
``_while_loop`` or ``_cond`` node (``ops/control_flow.py``).  Outer
variables the body captures join the node's inputs, so the executor
binds them.
"""

from __future__ import annotations

import math

from .symbol import Symbol, Group, var, _sym_invoke

__all__ = ["foreach", "while_loop", "cond", "rand_zipfian"]


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _maybe_scalar(lst, was_scalar):
    return lst[0] if was_scalar and len(lst) == 1 else lst


def _var_nodes(subgraph):
    return {n.name: Symbol([(n, 0)])
            for n in subgraph._topo() if n.is_var}


def _group(symbols):
    return Group(symbols) if len(symbols) > 1 else symbols[0]


def foreach(body, data, init_states, name="foreach"):
    """Scan ``body(data_t, states) -> (outputs, new_states)`` over axis 0
    of *data*.  Returns (outputs, final_states)."""
    data_l = _as_list(data)
    states_l = _as_list(init_states)
    data_scalar = not isinstance(data, (list, tuple))
    states_scalar = not isinstance(init_states, (list, tuple))
    data_names = ["__foreach_data%d" % i for i in range(len(data_l))]
    state_names = ["__foreach_state%d" % i for i in range(len(states_l))]
    outs, new_states = body(
        _maybe_scalar([var(n) for n in data_names], data_scalar),
        _maybe_scalar([var(n) for n in state_names], states_scalar))
    outs_scalar = not isinstance(outs, (list, tuple))
    outs_l = _as_list(outs)
    new_states_l = _as_list(new_states)
    if len(new_states_l) != len(states_l):
        raise ValueError("body must return as many states as init_states")
    sub = _group(outs_l + new_states_l)
    bound = set(data_names + state_names)
    closure_names = [a for a in sub.list_inputs() if a not in bound]
    vmap = _var_nodes(sub)
    out = _sym_invoke(
        "_foreach", data_l + states_l + [vmap[n] for n in closure_names],
        {"subgraph": sub, "n_data": len(data_l),
         "n_states": len(states_l), "n_outputs": len(outs_l),
         "data_names": tuple(data_names),
         "state_names": tuple(state_names),
         "closure_names": tuple(closure_names)},
        name=name)
    outputs = [out[i] for i in range(len(outs_l))]
    finals = [out[len(outs_l) + i] for i in range(len(states_l))]
    return (_maybe_scalar(outputs, outs_scalar),
            _maybe_scalar(finals, states_scalar))


def while_loop(cond, func, loop_vars, max_iterations, name="while_loop"):
    """Run ``func(*loop_vars) -> (outputs, new_loop_vars)`` while
    ``cond(*loop_vars)`` holds, at most *max_iterations* times.  Outputs
    are stacked over an axis 0 of *max_iterations* rows (rows not
    executed are zeros); returns (outputs, final_loop_vars)."""
    lvars = _as_list(loop_vars)
    lscalar = not isinstance(loop_vars, (list, tuple))
    lnames = ["__while_var%d" % i for i in range(len(lvars))]
    lvs = [var(n) for n in lnames]
    cond_sub = cond(*lvs)
    outs, new_vars = func(*lvs)
    outs_l = _as_list(outs)
    new_l = _as_list(new_vars)
    if len(new_l) != len(lvars):
        raise ValueError("func must return as many loop_vars as given")
    func_sub = _group(outs_l + new_l)
    bound = set(lnames)
    cond_clo = [a for a in cond_sub.list_inputs() if a not in bound]
    func_clo = [a for a in func_sub.list_inputs() if a not in bound]
    cmap, fmap = _var_nodes(cond_sub), _var_nodes(func_sub)
    out = _sym_invoke(
        "_while_loop",
        lvars + [cmap[n] for n in cond_clo] + [fmap[n] for n in func_clo],
        {"cond_graph": cond_sub, "func_graph": func_sub,
         "max_iterations": int(max_iterations),
         "n_loop_vars": len(lvars), "n_outputs": len(outs_l),
         "loop_var_names": tuple(lnames),
         "cond_closure_names": tuple(cond_clo),
         "func_closure_names": tuple(func_clo)},
        name=name)
    outputs = [out[i] for i in range(len(outs_l))]
    finals = [out[len(outs_l) + i] for i in range(len(lvars))]
    return (outputs[0] if len(outputs) == 1 else outputs,
            _maybe_scalar(finals, lscalar))


def cond(pred, then_func, else_func, name="cond"):
    """Branch on the scalar Symbol *pred*: ``then_func()`` where it is
    nonzero, else ``else_func()``; both must give the same output
    spec."""
    then_out = then_func()
    else_out = else_func()
    then_l = _as_list(then_out)
    else_l = _as_list(else_out)
    if len(then_l) != len(else_l):
        raise ValueError("then/else must return the same number of "
                         "outputs")
    tscalar = not isinstance(then_out, (list, tuple))
    then_sub, else_sub = _group(then_l), _group(else_l)
    pred_names = pred.list_inputs()
    then_names = then_sub.list_inputs()
    else_names = else_sub.list_inputs()
    pmap, tmap, emap = (_var_nodes(pred), _var_nodes(then_sub),
                        _var_nodes(else_sub))
    out = _sym_invoke(
        "_cond",
        [pmap[n] for n in pred_names] + [tmap[n] for n in then_names] +
        [emap[n] for n in else_names],
        {"pred_graph": pred, "then_graph": then_sub,
         "else_graph": else_sub, "n_outputs": len(then_l),
         "pred_names": tuple(pred_names),
         "then_names": tuple(then_names),
         "else_names": tuple(else_names)},
        name=name)
    return _maybe_scalar([out[i] for i in range(len(then_l))], tscalar)


def rand_zipfian(true_classes, num_sampled, range_max):
    """Symbolic log-uniform candidate sampler: (samples, expected count
    of each true class, expected count of each sample), the same math
    as ``nd.contrib.rand_zipfian`` from symbolic ops."""
    from .. import symbol as sym_pkg
    log_range = math.log(range_max + 1)
    u = sym_pkg._random_uniform(low=0.0, high=1.0,
                                shape=(int(num_sampled),))
    sampled = sym_pkg.floor(sym_pkg.exp(u * log_range) - 1.0)
    sampled = sampled - sym_pkg.floor(sampled / range_max) * range_max

    def expected(cls):
        p = (sym_pkg.log((cls + 2.0) / (cls + 1.0))) / log_range
        return p * float(num_sampled)

    return sampled, expected(true_classes), expected(sampled)
