"""The north-star trainer (port of ``mxnet_tpu/parallel/data_parallel.py``
``ParallelTrainer``, one device).

In the JAX package the whole training step (forward, backward, gradient
all-reduce, fused optimizer update) is one jitted SPMD program over a
mesh, with the parameter buffers donated.  Here, on one device, the step
is one Python function over name -> tensor dicts: the traced loss graph
is evaluated eagerly (``executor._build_eval``), ``torch.autograd.grad``
takes the gradients of the trainable leaves (nothing accumulates into
``.grad``), and the update ops write every weight and state in place
under ``no_grad``.

It carries the JAX trainer's numerics: the loss is the float32 mean of
the loss output; bf16 compute weights with float32 masters under
``multi_precision`` (batches of floats cast to bf16, integer ids kept);
an optional global-norm ``grad_clip``; LARS (``optimizer='lars'`` or
``'lbsgd'``), a per-tensor trust ratio eta ||w|| / (||g|| + wd ||w|| +
epsilon) computed in float32 from the master and the float32 gradient,
1 where either norm is 0, kept on the device; and the coalesced apply of
small parameters (``coalesce_small``).

``coalesce_small`` (default: on for LARS with the (mp_)sgd[_mom] ops)
keeps every parameter of at most 8192 values, its master and its
momentum as views into flat buffers, so their LARS norms
(``torch._foreach_norm``) and their update run as a handful of kernels
over the whole set instead of several launches per tensor (a ResNet-50
step has 110 such tensors).  It computes what the per-tensor path
computes, in float32, and agrees with it within float32 rounding.

``remat``: None, ``'full'`` (``torch.utils.checkpoint`` around the loss:
recompute every activation), ``'dots'`` (selective checkpointing that
saves the outputs of matrix products and convolutions and recomputes the
rest, the counterpart of ``dots_with_no_batch_dims_saveable``) or a
callable taken as the selective-checkpoint policy.

Graph arguments with no Parameter behind them (the begin states a fused
RNN layer creates when called without states) are zero-filled frozen
inputs at the shapes ``Symbol.infer_shape`` gives for the batch.

Not ported, each raising ``MXNetError``: ``fit()`` (needs ``io``
DataIters and ``resilience``), ``param_specs`` (tensor parallelism) and
a mesh of more than one device.
"""

from __future__ import annotations

import functools

import torch

from ..base import MXNetError
from ..context import cpu
from ..ndarray import NDArray
from .mesh import make_mesh

__all__ = ["ParallelTrainer"]

# optimizer name -> (update op, number of zero-init states).  State layout
# of the update ops: fn(weight, grad, *states, **hyper), updated in place.
_OPT_OPS = {
    "sgd": ("sgd_update", 0),
    "sgd_mom": ("sgd_mom_update", 1),
    "nag": ("nag_mom_update", 1),
    "adam": ("adam_update", 2),
    "rmsprop": ("rmsprop_update", 1),
    "rmspropalex": ("rmspropalex_update", 3),
    "ftrl": ("ftrl_update", 2),
    "ftml": ("ftml_update", 3),
    "signum": ("signum_update", 1),
    "signsgd": ("signsgd_update", 0),
    "adadelta": ("adadelta_update", 2),
    "adamax": ("adamax_update", 2),
    "nadam": ("nadam_update", 2),
}

# LARS-family: layer-wise trust ratio scaling wrapped around momentum sgd
_LARS_NAMES = ("lars", "lbsgd")

# parameters of at most this many values take the coalesced apply
_SMALL_MAX = 8192


def _not_ported(what, item):
    return MXNetError("ParallelTrainer: %s is not ported (ROADMAP queue A "
                      "%s)" % (what, item))


def _dots_policy():
    """The 'dots' selective-checkpoint policy: keep the outputs of matrix
    products without batch dims and of convolutions, recompute the rest."""
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    saved = {aten.mm.default, aten.addmm.default, aten.convolution.default}

    def policy(ctx, op, *args, **kwargs):
        if op in saved:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return policy


class ParallelTrainer:
    """Train a Gluon HybridBlock + loss + optimizer, one step a call.

    Parameters
    ----------
    net : HybridBlock (traced symbolically, like hybridize)
    loss : gluon loss HybridBlock
    optimizer : any name of ``_OPT_OPS`` ('sgd', 'adam', 'rmsprop', ...)
        or 'lars'/'lbsgd'; momentum > 0 upgrades sgd to the momentum op
    mesh : a ``make_mesh`` mesh (default: ``cuda:0``)
    shard_params : ZeRO-style sharding over dp; with one device there is
        nothing to shard
    multi_precision : bf16 compute weights + float32 master copies (bf16
        float batches, float32 loss and update math); needs the (mp_)sgd
        ops
    grad_clip : optional global-norm clip
    remat, coalesce_small : see the module docstring
    param_specs : tensor parallelism; not ported
    """

    def __init__(self, net, loss, optimizer="sgd", optimizer_params=None,
                 mesh=None, shard_params=False, grad_clip=None,
                 multi_precision=False, remat=None, coalesce_small=None,
                 param_specs=None):
        if param_specs:
            raise _not_ported("param_specs (tensor parallelism)",
                              "item 14")
        if remat not in (None, "full", "dots") and not callable(remat):
            raise ValueError("remat must be None, 'full', 'dots' or a "
                             "selective-checkpoint policy")
        self.net = net
        self.loss = loss
        self.mesh = mesh or make_mesh()
        self.device = self.mesh.device
        self.opt_name = optimizer
        self.opt_params = dict(optimizer_params or {})
        self.shard_params = shard_params
        self.grad_clip = grad_clip
        self.multi_precision = multi_precision
        self.coalesce_small = coalesce_small
        self.remat = remat
        self.dispatch_count = 0
        self._built = False
        self._params = None          # name -> tensor on the mesh's device
        self._opt_state = None       # name -> tuple of state tensors
        self._aux = None
        self._graph = None
        self._num_update = 0
        # the step's random stream (the JAX trainer splits a PRNGKey)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(0)

    # -- tracing -----------------------------------------------------------
    def _trace(self):
        from .. import symbol as sym_mod
        from ..executor import _build_eval
        data = sym_mod.var("data0")
        label = sym_mod.var("label0")
        out = self.net(data)
        loss_sym = self.loss(out, label)
        self._graph = loss_sym
        self._eval = _build_eval(loss_sym, True)
        self._eval_infer = _build_eval(loss_sym, False)
        out_syms = out if isinstance(out, sym_mod.Symbol) else out[0]
        self._fwd_eval = _build_eval(out_syms, False)
        args = loss_sym.list_arguments()
        self.param_names = [a for a in args if a not in ("data0", "label0")]
        self.aux_names = loss_sym.list_auxiliary_states()

    def _resolve_opt(self):
        from ..ops.registry import get_op
        name = self.opt_name
        self._lars = name in _LARS_NAMES
        if self._lars:
            name = "sgd"
        if name == "sgd" and self.opt_params.get("momentum", 0):
            name = "sgd_mom"
        if name not in _OPT_OPS:
            raise ValueError(
                "optimizer %r not supported by ParallelTrainer; one of %s"
                % (self.opt_name, sorted(_OPT_OPS) + list(_LARS_NAMES)))
        base_op, n_states = _OPT_OPS[name]
        self._opt_base = name
        if self.multi_precision:
            if name not in ("sgd", "sgd_mom"):
                raise ValueError(
                    "multi_precision needs the mp_sgd update kernels; "
                    "use optimizer='sgd'/'lars'/'lbsgd' (got %r)"
                    % self.opt_name)
            base_op = "mp_" + base_op
        self._opt_op = get_op(base_op)
        self._opt_n_states = n_states

    def _gather_state(self, data_shape=None, label_shape=None):
        params = {p.name: p for p in self.net.collect_params().values()}
        self._resolve_opt()
        # graph arguments with no Parameter behind them (auto-created
        # begin-state variables) are zero-filled inputs, as simple_bind
        # fills unbound arguments: no optimizer state, never updated
        self._frozen = frozenset(n for n in self.param_names
                                 if n not in params)
        frozen = {}
        if self._frozen:
            frozen = self._infer_frozen(data_shape, label_shape)
            self._frozen_built_for = (tuple(data_shape or ()),
                                      tuple(label_shape or ()))
        self._params = {}
        self._opt_state = {}
        for n in self.param_names:
            if n in self._frozen:
                self._params[n] = frozen[n]
                self._opt_state[n] = ()
                continue
            arr, states = self._state_for_array(params[n].data()._data)
            self._params[n] = arr
            self._opt_state[n] = tuple(states)
        self._aux = {n: params[n].data()._data.detach().to(
            self.device, copy=True) for n in self.aux_names}

    def _infer_frozen(self, data_shape, label_shape):
        """Zeros for the frozen graph arguments at the shapes
        ``Symbol.infer_shape`` gives for this batch geometry (every
        Parameter's shape is known)."""
        shapes = {}
        if data_shape is not None:
            shapes["data0"] = tuple(data_shape)
        if label_shape is not None:
            shapes["label0"] = tuple(label_shape)
        for p in self.net.collect_params().values():
            if p.name in self.param_names and p.shape and \
                    all(int(s) > 0 for s in p.shape):
                shapes[p.name] = tuple(int(s) for s in p.shape)
        arg_shapes, _, _ = self._graph.infer_shape(**shapes)
        inferred = dict(zip(self._graph.list_arguments(), arg_shapes))
        dtype = torch.bfloat16 if self.multi_precision else torch.float32
        return {n: torch.zeros(inferred[n], dtype=dtype, device=self.device)
                for n in self._frozen}

    def _refresh_frozen(self, x_shape, y_shape=None):
        """New zeros for the frozen arguments when the batch geometry
        changes (with no label, its shape follows the stored one at the
        new batch size)."""
        if not self._frozen:
            return
        if y_shape is None:
            y_shape = (tuple(x_shape)[0],) + self._frozen_built_for[1][1:]
        key = (tuple(x_shape), tuple(y_shape))
        if key != self._frozen_built_for:
            self._params.update(self._infer_frozen(*key))
            self._frozen_built_for = key

    def _state_for_array(self, arr):
        """(stored tensor, fresh optimizer states) for one parameter on
        the mesh's device, honoring multi_precision (bf16 compute +
        float32 master copy as the last state)."""
        if self.multi_precision:
            master = arr.detach().to(self.device, torch.float32, copy=True)
            states = [torch.zeros_like(master)
                      for _ in range(self._opt_n_states)]
            states.append(master)
            return master.to(torch.bfloat16), states
        arr = arr.detach().to(self.device, copy=True)
        # states match the stored weight dtype, as in the JAX trainer
        return arr, [torch.zeros_like(arr)
                     for _ in range(self._opt_n_states)]

    # -- the step ------------------------------------------------------------
    def _build_step(self):
        opt_op = self._opt_op
        self._opt_hp = {k: v for k, v in self.opt_params.items()
                        if k in opt_op.param_names and k not in ("lr", "t")}
        coalesce = self.coalesce_small
        if coalesce is None:
            coalesce = self._lars
        supported = (not self.shard_params
                     and self._opt_base in ("sgd", "sgd_mom"))
        if self.coalesce_small and not supported:
            raise ValueError(
                "coalesce_small=True requires an (mp_)sgd[_mom] optimizer "
                "and shard_params=False (got optimizer base %r, "
                "shard_params=%r); drop the flag to use the per-tensor "
                "apply path" % (self._opt_base, self.shard_params))
        small = []
        if coalesce and supported:
            small = [n for n in self.param_names if n not in self._frozen
                     and self._params[n].numel() <= _SMALL_MAX]
            # one flat buffer holds one dtype
            small = [n for n in small
                     if self._params[n].dtype == self._params[small[0]].dtype]
        self._small = small if len(small) >= 2 else []
        if self._small:
            self._coalesce()
        self._built = True

    def _coalesce(self):
        """Move the small parameters, their momenta and masters into flat
        buffers; the per-name tensors become views of them."""
        small = self._small
        sizes = [self._params[n].numel() for n in small]
        dev = self.device

        def flatten(tensors):
            flat = torch.cat([t.reshape(-1) for t in tensors])
            views = [v.view(t.shape) for v, t in
                     zip(flat.split(sizes), tensors)]
            return flat, views

        flat_w, views_w = flatten([self._params[n] for n in small])
        slots = len(self._opt_state[small[0]])
        flat_s, views_s = [], []
        for i in range(slots):
            f, v = flatten([self._opt_state[n][i] for n in small])
            flat_s.append(f)
            views_s.append(v)
        for j, n in enumerate(small):
            self._params[n] = views_w[j]
            self._opt_state[n] = tuple(v[j] for v in views_s)
        self._flat_w = flat_w
        self._flat_mom = flat_s[0] if self._opt_base == "sgd_mom" else None
        self._flat_w32 = flat_s[-1] if self.multi_precision else None
        self._small_sizes = sizes
        self._small_repeats = torch.tensor(sizes, device=dev)

    def _value_and_grad(self, x, y):
        """(float32 mean loss, {name: gradient}, {aux name: new value})
        of one training forward and backward at the current weights."""
        eval_fn = self._eval
        aux = self._aux
        gen = self._gen
        gen_state = gen.get_state()
        leaves = {n: t.detach().requires_grad_()
                  for n, t in self._params.items() if n not in self._frozen}

        def loss_of():
            # a recomputing backward (remat) draws the same randomness
            gen.set_state(gen_state)
            amap = dict(self._params)
            amap.update(leaves)
            amap["data0"] = x
            amap["label0"] = y
            outs, auxu = eval_fn(amap, aux, gen)
            return torch.mean(outs[0].float()), auxu

        with torch.enable_grad():
            if self.remat is None:
                loss, auxu = loss_of()
            else:
                from torch.utils import checkpoint as ckpt
                kw = {}
                if self.remat != "full":
                    policy = _dots_policy() if self.remat == "dots" \
                        else self.remat
                    kw["context_fn"] = functools.partial(
                        ckpt.create_selective_checkpoint_contexts, policy)
                loss, auxu = ckpt.checkpoint(loss_of, use_reentrant=False,
                                             **kw)
            names = list(leaves)
            grads = torch.autograd.grad(loss, [leaves[n] for n in names])
        return loss.detach(), dict(zip(names, grads)), \
            {n: v.detach() for n, v in auxu.items()}

    def _clip_grads(self, grads):
        """Scale every gradient by min(1, grad_clip / (global norm +
        1e-8)), the norm in float32."""
        norms = [torch.linalg.vector_norm(g, dtype=torch.float32)
                 for g in grads.values()]
        gnorm = torch.linalg.vector_norm(torch.stack(norms))
        scale = torch.clamp(self.grad_clip / (gnorm + 1e-8), max=1.0)
        return {n: (g.float() * scale).to(g.dtype) for n, g in grads.items()}

    def _trust(self, wnorm, gnorm):
        """LARS trust ratio from float32 norms; 1 where either is 0."""
        eta = float(self.opt_params.get("eta", 0.001))
        eps = float(self.opt_params.get("epsilon", 1e-9))
        wd = float(self.opt_params.get("wd", 0.0))
        return torch.where((wnorm > 0) & (gnorm > 0),
                           eta * wnorm / (gnorm + wd * wnorm + eps),
                           torch.ones_like(wnorm))

    def _apply_update(self, grads, lr, t):
        """Apply the optimizer to every parameter in place: the
        per-tensor ops, then the coalesced small set."""
        if self.grad_clip is not None:
            grads = self._clip_grads(grads)
        op = self._opt_op
        hp = dict(self._opt_hp)
        if "t" in op.param_names:
            hp["t"] = t
        # adadelta has no learning rate (the JAX trainer passes one anyway
        # and fails)
        takes_lr = "lr" in op.param_names
        small = set(self._small)
        mp = self.multi_precision
        with torch.no_grad():
            for n, w in self._params.items():
                if n in small or n in self._frozen:
                    continue
                g = grads[n]
                states = self._opt_state[n]
                lr_n = lr
                if self._lars:
                    w32 = states[-1] if mp else w.float()
                    lr_n = lr * self._trust(
                        torch.linalg.vector_norm(w32),
                        torch.linalg.vector_norm(g, dtype=torch.float32))
                if takes_lr:
                    hp["lr"] = lr_n
                op.fn(w, g, *states, **hp)
            if self._small:
                self._apply_small(grads, lr)

    def _apply_small(self, grads, lr):
        """The (mp_)sgd[_mom] update of the small set over the flat
        buffers: rescale -> clip -> + wd * w32, as ``_rescale_clip``."""
        sizes = self._small_sizes
        mp = self.multi_precision
        w32 = self._flat_w32 if mp else self._flat_w.float()
        g = torch.cat([grads[n].reshape(-1) for n in self._small]).float()
        if self._lars:
            wn = torch.stack(torch._foreach_norm(list(w32.split(sizes))))
            gn = torch.stack(torch._foreach_norm(list(g.split(sizes))))
            lr_elem = torch.repeat_interleave(
                lr * self._trust(wn, gn), self._small_repeats,
                output_size=w32.numel())
        else:
            lr_elem = lr
        g.mul_(float(self.opt_params.get("rescale_grad", 1.0)))
        clip = float(self.opt_params.get("clip_gradient", -1.0))
        if clip >= 0:
            g.clamp_(-clip, clip)
        g.add_(float(self.opt_params.get("wd", 0.0)) * w32)
        if self._flat_mom is not None:
            mom = self._flat_mom.float()
            mom.mul_(float(self.opt_params.get("momentum", 0.0)))
            mom.sub_(lr_elem * g)
            w32.add_(mom)
            if mom is not self._flat_mom:
                self._flat_mom.copy_(mom)
        else:
            w32.sub_(lr_elem * g)
        if w32 is not self._flat_w:
            self._flat_w.copy_(w32)

    def _ensure_built(self, x, y):
        if not self._built:
            self.net._ensure_params(NDArray(x))
            self._trace()
            self._gather_state(data_shape=x.shape, label_shape=y.shape)
            self._build_step()

    @staticmethod
    def _tensor(a):
        if isinstance(a, NDArray):
            return a._data
        if isinstance(a, torch.Tensor):
            return a
        return NDArray(a)._data

    def _device_batch(self, x):
        """The batch on the mesh's device; under multi_precision floats
        become bf16 and integer ids stay as they are (a float id cast to
        bf16 rounds to a multiple of 128 above 256)."""
        x = self._tensor(x).to(self.device)
        if self.multi_precision and x.is_floating_point():
            x = x.to(torch.bfloat16)
        return x

    def _label_batch(self, y):
        return self._tensor(y).to(self.device)

    def fit(self, *args, **kwargs):
        raise _not_ported("fit() (needs resilience's checkpoints)",
                          "item 15")

    def fit_batch(self, x, y):
        """Run one training step; returns the float32 mean loss (a 0-dim
        tensor on the device)."""
        x, y = self._tensor(x), self._tensor(y)
        self._ensure_built(x, y)
        self._refresh_frozen(x.shape, y.shape)
        xd, yd = self._device_batch(x), self._label_batch(y)
        loss, grads, auxu = self._value_and_grad(xd, yd)
        self._apply_update(grads, self._current_lr(), self._num_update + 1)
        with torch.no_grad():
            for n, v in auxu.items():
                self._aux[n].copy_(v)
        self._num_update += 1
        self.dispatch_count += 1
        return loss

    def _current_lr(self):
        sched = self.opt_params.get("lr_scheduler")
        if sched is not None:
            return float(sched(self._num_update))
        return float(self.opt_params.get("learning_rate", 0.01))

    def evaluate_batch(self, x, y):
        """Mean loss over one batch, inference mode (no aux updates)."""
        x, y = self._tensor(x), self._tensor(y)
        self._ensure_built(x, y)
        self._refresh_frozen(x.shape, y.shape)
        amap = dict(self._params, data0=self._device_batch(x),
                    label0=self._label_batch(y))
        with torch.no_grad():
            outs, _ = self._eval_infer(amap, self._aux, self._gen)
            return torch.mean(outs[0].float())

    def predict_batch(self, x):
        """Network outputs for one batch, inference mode."""
        if not self._built:
            raise RuntimeError("run fit_batch or evaluate_batch first")
        self._refresh_frozen(self._tensor(x).shape)
        amap = dict(self._params, data0=self._device_batch(x))
        with torch.no_grad():
            outs, _ = self._fwd_eval(amap, self._aux, self._gen)
        return NDArray(outs[0])

    # -- checkpoint / resume -------------------------------------------------
    def save_checkpoint(self, prefix, epoch=0):
        """Write the full training state (params, optimizer state, aux,
        update counter) in the JAX trainer's file layout, entries in
        ``param_names`` (graph) order.  Returns the params path."""
        import numpy as _np
        from .. import ndarray as _nd
        blob = {}
        for n in self.param_names:
            blob["arg:%s" % n] = NDArray(self._params[n])
            for i, s in enumerate(self._opt_state[n]):
                blob["opt%d:%s" % (i, n)] = NDArray(s)
        for n in self.aux_names:
            blob["aux:%s" % n] = NDArray(self._aux[n])
        blob["meta:num_update"] = NDArray(
            _np.asarray([self._num_update], _np.int64))
        path = "%s-%04d.params" % (prefix, epoch)
        _nd.save(path, blob)
        return path

    def load_checkpoint(self, prefix, epoch=0):
        """Restore state written by :meth:`save_checkpoint` (of either
        package) into this built trainer, in place.  Names that differ only
        in their auto-generated counters are matched by position; every
        shape and state count is checked before anything is written."""
        from .. import ndarray as _nd
        if not self._built:
            raise RuntimeError("build the trainer first (run one "
                               "fit_batch) before loading a checkpoint")
        loaded = _nd.load("%s-%04d.params" % (prefix, epoch), ctx=cpu())
        params, opt, aux = {}, {}, {}
        num_update = self._num_update
        for k, v in loaded.items():
            kind, name = k.split(":", 1)
            if kind == "arg":
                params[name] = v._data
            elif kind.startswith("opt"):
                opt.setdefault(name, {})[int(kind[3:])] = v._data
            elif kind == "aux":
                aux[name] = v._data
            elif k == "meta:num_update":
                num_update = int(v.asnumpy()[0])
        if len(params) != len(self._params) or len(aux) != len(self._aux):
            raise ValueError(
                "checkpoint has %d params / %d aux, trainer has %d / %d"
                % (len(params), len(aux), len(self._params),
                   len(self._aux)))
        if set(params) != set(self._params) or set(aux) != set(self._aux):
            # same architecture under other name counters: both sides are
            # in graph (construction) order
            remap = dict(zip(params, self.param_names))
            remap.update(zip(aux, self.aux_names))
            params = {remap[n]: a for n, a in params.items()}
            opt = {remap[n]: s for n, s in opt.items()}
            aux = {remap[n]: a for n, a in aux.items()}
        pairs = []
        for n, a in params.items():
            pairs.append((n, a, self._params[n]))
            slots = opt.get(n, {})
            if sorted(slots) != list(range(len(self._opt_state[n]))):
                raise ValueError(
                    "checkpoint entry %r holds %d optimizer states, the "
                    "trainer %d" % (n, len(slots), len(self._opt_state[n])))
            pairs += [(n, slots[i], s)
                      for i, s in enumerate(self._opt_state[n])]
        pairs += [(n, a, self._aux[n]) for n, a in aux.items()]
        for n, src, dst in pairs:
            if tuple(src.shape) != tuple(dst.shape) or \
                    src.dtype != dst.dtype:
                raise ValueError(
                    "checkpoint entry for %r is %s %s, the trainer's %s %s"
                    % (n, tuple(src.shape), src.dtype, tuple(dst.shape),
                       dst.dtype))
        with torch.no_grad():
            for _, src, dst in pairs:
                dst.copy_(src)
        self._num_update = num_update

    # -- sync back to gluon parameters --------------------------------------
    def sync_params(self):
        """Write the trained values back into the Block's Parameters
        (the float32 masters under multi_precision)."""
        params = {p.name: p for p in self.net.collect_params().values()}
        for n, arr in self._params.items():
            if n in self._frozen:
                continue
            if self.multi_precision:
                arr = self._opt_state[n][-1]
            params[n].set_data(NDArray(arr))
        for n, arr in self._aux.items():
            params[n].set_data(NDArray(arr))

    @property
    def params(self):
        return self._params
