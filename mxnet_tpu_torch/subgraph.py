"""Graph partitioning (port of ``mxnet_tpu/subgraph.py``, ``mx.subgraph``).

A ``SubgraphProperty`` supplies a ``SubgraphSelector`` that marks nodes;
``partition_graph`` grows convex components from the selected nodes (no
node outside a component lies on a path between two of its members) and
replaces each component of two or more nodes with one ``_subgraph_exec``
node (``ops/control_flow.py``) carrying the sub-Symbol.  A property may
rewrite the captured sub-Symbol first (``rewrite_subgraph``).  Nodes that
read auxiliary states (BatchNorm's moving statistics) are never absorbed:
their updates would be lost inside the subgraph.  ``bind`` and
``simple_bind`` partition by the backend named in
``MXNET_SUBGRAPH_BACKEND``.
"""

from __future__ import annotations

__all__ = ["SubgraphSelector", "SubgraphProperty",
           "register_subgraph_property", "get_subgraph_property",
           "list_subgraph_backends", "partition_graph"]


class SubgraphSelector(object):
    """Node-selection contract (reference: subgraph_property.h:40-90)."""

    def select(self, node):
        """Start/continue a subgraph at *node*?"""
        return False

    def select_input(self, node, input_node):
        """Grow from *node* to its producer *input_node*?"""
        return self.select(input_node)

    def select_output(self, node, output_node):
        """Grow from *node* to its consumer *output_node*?"""
        return self.select(output_node)


class SubgraphProperty(object):
    """Backend hook: a selector plus the replacement-node factory
    (reference: subgraph_property.h:93, CreateSubgraphNode:105)."""

    def create_subgraph_selector(self):
        return SubgraphSelector()

    def rewrite_subgraph(self, subgraph_sym, subgraph_id):
        """Hook: transform the captured sub-Symbol before wrapping
        (quantize it, fuse it, ...).  Default: unchanged."""
        return subgraph_sym

    def create_subgraph_node(self, subgraph_sym, input_entries,
                             subgraph_id):
        """Build the replacement node: one ``_subgraph_exec`` op
        executing *subgraph_sym* with *input_entries* bound to its
        placeholder variables by name."""
        from .symbol.symbol import Node
        sub = self.rewrite_subgraph(subgraph_sym, subgraph_id)
        from .ops import registry as _reg
        node = Node(_reg.get_op("_subgraph_exec"),
                    "subgraph%d" % subgraph_id,
                    params={"subgraph": sub,
                            "input_names": tuple(
                                nm for nm, _e in input_entries),
                            "n_outputs": len(sub._outputs)},
                    inputs=[entry for _nm, entry in input_entries])
        return node


_PROPERTIES = {}


def register_subgraph_property(name, prop):
    """Register a backend under *name* (reference:
    MXNET_REGISTER_SUBGRAPH_PROPERTY)."""
    _PROPERTIES[name] = prop
    return prop


def get_subgraph_property(name):
    prop = _PROPERTIES[name]
    return prop() if isinstance(prop, type) else prop


def list_subgraph_backends():
    return sorted(_PROPERTIES)


def partition_graph(symbol, prop_or_name=None):
    """Partition *symbol* through a SubgraphProperty; returns a new
    Symbol with matched convex components replaced by _subgraph_exec
    nodes (reference: partition_graph.cc:738 PartitionGraph)."""
    from .symbol.symbol import Node, Symbol

    if prop_or_name is None:
        from .config import get_env
        prop_or_name = get_env("MXNET_SUBGRAPH_BACKEND")
        if not prop_or_name:
            return symbol
    prop = (get_subgraph_property(prop_or_name)
            if isinstance(prop_or_name, str) else prop_or_name)
    selector = prop.create_subgraph_selector()

    topo = symbol._topo()
    aux_ids = symbol._aux_var_ids()

    # ---- grow convex components in topo order -------------------------
    comp_of = {}     # id(node) -> component index
    comps = []       # component index -> [member nodes, topo order]
    anc_comps = {}   # id(node) -> set of component indices among ancestors

    for node in topo:
        acc = set()
        for inp, _s in node.inputs:
            acc |= anc_comps.get(id(inp), set())
            if id(inp) in comp_of:
                acc.add(comp_of[id(inp)])
        if not node.is_var:
            touches_aux = any(id(inp) in aux_ids
                              for inp, _s in node.inputs)
            if not touches_aux and selector.select(node):
                joined = None
                for inp, _s in node.inputs:
                    ci = comp_of.get(id(inp))
                    if ci is None or \
                            not selector.select_output(inp, node) or \
                            not selector.select_input(node, inp):
                        continue
                    # convexity: every other input that transitively
                    # depends on ci must itself be inside ci
                    ok = all(
                        comp_of.get(id(other)) == ci or
                        ci not in anc_comps.get(id(other), ())
                        for other, _t in node.inputs)
                    if ok:
                        joined = ci
                        break
                if joined is None:
                    joined = len(comps)
                    comps.append([])
                comps[joined].append(node)
                comp_of[id(node)] = joined
        anc_comps[id(node)] = acc

    live = {ci for ci, c in enumerate(comps) if len(c) >= 2}
    if not live:
        return symbol
    member_of = {id(n): ci for ci, c in enumerate(comps)
                 for n in c if ci in live}

    # ---- usage map: which output entries are consumed where -----------
    users = {}       # id(node) -> [(consumer node, out_slot used)]
    for n in topo:
        for inp, slot in n.inputs:
            users.setdefault(id(inp), []).append((n, slot))
    head_set = {(id(n), s) for n, s in symbol._outputs}

    # ---- reconstruction: create replacement nodes with RAW (original)
    # input entries, then patch every created node's inputs through the
    # completed entry_map — a component finalized late in topo order can
    # feed one finalized early, so resolution must be deferred until the
    # map is complete (else the original producer leaks into the new
    # graph and runs twice).
    entry_map = {}   # (id(old node), slot) -> (new node, slot)
    created = []     # new nodes whose .inputs hold raw original entries
    remaining = {ci: len(comps[ci]) for ci in live}

    def finalize(ci):
        members = comps[ci]
        member_ids = {id(m) for m in members}
        # external inputs (order = first use), placeholder vars by name
        ext, var_map = [], {}
        for m in members:
            for inp, slot in m.inputs:
                if id(inp) in member_ids:
                    continue
                key = (id(inp), slot)
                if key in var_map:
                    continue
                pname = (inp.name if inp.is_var
                         else "__sg%d_in%d" % (ci, len(ext)))
                var_map[key] = Node(None, pname)
                ext.append((pname, (inp, slot)))
        # member output entries visible outside
        out_entries = []
        for m in members:
            slots = sorted({s for u, s in users.get(id(m), [])
                            if id(u) not in member_ids} |
                           {s for nid, s in head_set if nid == id(m)})
            out_entries.extend((m, s) for s in slots)
        # clone members into the sub-Symbol over placeholder vars
        clones = {}

        def clone(n):
            if id(n) in clones:
                return clones[id(n)]
            new_inputs = []
            for inp, slot in n.inputs:
                if id(inp) in member_ids:
                    new_inputs.append((clone(inp), slot))
                else:
                    new_inputs.append((var_map[(id(inp), slot)], 0))
            c = Node(n.op, n.name, dict(n.params), new_inputs,
                     dict(n.attrs))
            clones[id(n)] = c
            return c

        sub_sym = Symbol([(clone(n), s) for n, s in out_entries])
        sg_node = prop.create_subgraph_node(sub_sym, ext, ci)
        created.append(sg_node)
        for out_slot, (m, s) in enumerate(out_entries):
            entry_map[(id(m), s)] = (sg_node, out_slot)

    for node in topo:
        ci = member_of.get(id(node))
        if ci is not None:
            remaining[ci] -= 1
            if remaining[ci] == 0:
                finalize(ci)
            continue
        if node.is_var:
            continue
        # clone iff any input was (or will be) remapped — members of
        # not-yet-finalized components count
        if not any((id(inp), slot) in entry_map or id(inp) in member_of
                   for inp, slot in node.inputs):
            continue
        clone = Node(node.op, node.name, dict(node.params),
                     list(node.inputs), dict(node.attrs))
        created.append(clone)
        for s in range(node.num_outputs()):
            entry_map[(id(node), s)] = (clone, s)

    # ---- deferred patch: resolve raw entries through the full map -----
    for n in created:
        n.inputs = [entry_map.get((id(src), s), (src, s))
                    for src, s in n.inputs]
    new_heads = [entry_map.get((id(n), s), (n, s))
                 for n, s in symbol._outputs]
    return Symbol(new_heads)


# --- built-in demonstration backend ---------------------------------------

_ELEMWISE = {"Activation", "relu", "sigmoid", "tanh", "exp", "log",
             "negative", "sqrt", "square", "clip",
             "broadcast_add", "broadcast_sub", "broadcast_mul",
             "broadcast_div", "elemwise_add", "elemwise_sub",
             "elemwise_mul", "elemwise_div", "_plus_scalar",
             "_minus_scalar", "_mul_scalar", "_div_scalar"}


class _ElemwiseFuseSelector(SubgraphSelector):
    def select(self, node):
        return (not node.is_var) and node.op.name in _ELEMWISE


class ElemwiseFuseProperty(SubgraphProperty):
    """Groups contiguous elementwise chains into one ``_subgraph_exec``
    node: the demonstration backend (the group runs as one unit)."""

    def create_subgraph_selector(self):
        return _ElemwiseFuseSelector()


register_subgraph_property("MXTPU_FUSE", ElemwiseFuseProperty)
