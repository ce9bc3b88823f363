"""Pretrained-weight store (port of ``mxnet_tpu/gluon/model_zoo/
model_store.py``; reference: python/mxnet/gluon/model_zoo/model_store.py,
a sha1-indexed download of pretrained .params files).

There is no download path.  ``get_model_file`` resolves weights from the
local model directory only (``$MXNET_HOME/models`` or
``~/.mxnet/models``, where the reference caches its downloads), so a
checkpoint placed there (any file written by ``Block.save_parameters``)
loads as the reference's pretrained weights do; a missing file raises
with instructions.

The read probe runs under the resilience retry policy: transient
storage errors (a network file system flaking) back off and retry,
while a missing file fails at once.
"""

from __future__ import annotations

import os
import time

__all__ = ["get_model_file", "purge"]

# the probe's retry policy; _sleep is module-level so tests can stub the
# clock.  Errors that are not transient (missing file, permission
# denied, a directory) fail at once
_sleep = time.sleep
_RETRY = dict(attempts=4, base_delay=0.05, max_delay=0.5,
              retry_on=(OSError,),
              give_up_on=(FileNotFoundError, PermissionError,
                          IsADirectoryError, NotADirectoryError))


def _model_dir():
    return os.path.join(
        os.environ.get("MXNET_HOME",
                       os.path.join(os.path.expanduser("~"), ".mxnet")),
        "models")


def _probe(path):
    """Open the weight file and read a byte: an OSError here is how a
    flaky storage mount shows itself."""
    with open(path, "rb") as f:
        f.read(1)


def get_model_file(name, root=None):
    """Path of ``<root>/<name>.params``; raises FileNotFoundError when it
    is absent (where the reference would download it).  Transient read
    failures are retried with jittered backoff."""
    from ...resilience.retry import retry_call
    root = root or _model_dir()
    path = os.path.join(root, "%s.params" % name)
    try:
        retry_call(_probe, (path,), sleep=_sleep, **_RETRY)
    except FileNotFoundError:
        raise FileNotFoundError(
            "pretrained weights %r not found at %s. This build has no "
            "network egress: place the .params file there yourself (any "
            "checkpoint saved with save_parameters works), then retry."
            % (name, path))
    return path


def purge(root=None):
    """Remove the cached model files (reference: model_store.py purge)."""
    root = root or _model_dir()
    if not os.path.isdir(root):
        return
    for f in os.listdir(root):
        if f.endswith(".params"):
            os.unlink(os.path.join(root, f))
