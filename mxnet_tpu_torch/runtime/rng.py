"""The global random stream (port of ``mxnet_tpu/runtime/rng.py``).

The reference splits a functional PRNG key per random op; here each
device has one ``torch.Generator`` per thread, which every eager random
op on that device draws from.  ``seed`` reseeds them all, so one seed
gives the same draws twice.  The draws are PyTorch's, not the JAX
package's: the two streams agree in distribution only.
"""

from __future__ import annotations

import threading

import torch

__all__ = ["seed", "generator"]

_state = threading.local()
_DEFAULT_SEED = 0


def _gens():
    if not hasattr(_state, "gens"):
        _state.gens = {}
        _state.seed = _DEFAULT_SEED
    return _state.gens


def seed(seed_value):
    """Seed this thread's generator on every device (reference:
    ``mx.random.seed``)."""
    _gens().clear()
    _state.seed = int(seed_value)


def generator(device):
    """This thread's generator on *device* (a ``torch.device``), made on
    first use from the current seed."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    gens = _gens()
    gen = gens.get(device)
    if gen is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(_state.seed)
        gens[device] = gen
    return gen
