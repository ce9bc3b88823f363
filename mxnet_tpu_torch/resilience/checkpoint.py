"""Atomic file writes (port of ``mxnet_tpu/resilience/checkpoint.py``,
subset: ``atomic_write``, which the calibration tables, the tuning store
and the arrival traces persist through).  The checkpoint manager, its
manifests and the chaos file hooks are not ported."""

from __future__ import annotations

import itertools
import os

__all__ = ["atomic_write", "fsync_dir"]

_TMP_SEQ = itertools.count()


def fsync_dir(dirname):
    """Best-effort fsync of a directory so a rename survives power loss."""
    try:
        fd = os.open(dirname or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write(path, data, fsync=True):
    """Write *data* (bytes) to *path* atomically: a tmp file in the same
    directory, flush, fsync, ``os.replace``, directory fsync.  A crash at
    any point leaves either the old complete file or the new one."""
    if not isinstance(data, (bytes, bytearray, memoryview)):
        raise TypeError("atomic_write expects bytes, got %s"
                        % type(data).__name__)
    # pid + per-process sequence: concurrent writers of the same path
    # never share a tmp file
    tmp = "%s.tmp.%d.%d" % (path, os.getpid(), next(_TMP_SEQ))
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            if fsync:
                os.fsync(f.fileno())
        os.replace(tmp, path)
    except Exception:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    if fsync:
        fsync_dir(os.path.dirname(path))
