"""Server-role bootstrap (port of ``mxnet_tpu/kvstore_server.py``;
reference: python/mxnet/kvstore_server.py:85 — if DMLC_ROLE=server the
process blocks in RunServer).

Launch:  DMLC_ROLE=server DMLC_PS_ROOT_PORT=9091 DMLC_NUM_WORKER=2 \\
         python -m mxnet_tpu_torch.kvstore_server dist_sync

The parameter server is a host process: aggregation and the server-side
optimizer run on NDArrays on ``cpu()`` (the reference's ps-lite servers
are CPU processes), and nothing here creates a CUDA context, so workers
sharing a card lose none of its memory to the server.
"""

from __future__ import annotations

import os
import sys

from ._kvstore_impl import KVStoreServer


def run_server(kv_type="dist_sync", host=None, port=None, num_workers=None,
               snapshot_prefix=None):
    """Serve until a worker sends STOP; the address, world size and
    server id come from the reference's ``DMLC_*`` environment unless
    given."""
    sync = "async" not in kv_type
    # server s of a multi-server group listens at root port + s
    server_id = int(os.environ.get("DMLC_SERVER_ID", "0"))
    server = KVStoreServer(
        sync_mode=sync,
        num_workers=num_workers or
        int(os.environ.get("DMLC_NUM_WORKER", "1")),
        host=host or os.environ.get("DMLC_PS_ROOT_URI", "127.0.0.1"),
        port=port if port is not None else
        int(os.environ.get("DMLC_PS_ROOT_PORT", "9091")) + server_id,
        server_id=server_id,
        # None defers to MXNET_KVSTORE_SNAPSHOT_PREFIX; with either set,
        # the constructor restores the newest snapshot before serving
        snapshot_prefix=snapshot_prefix)
    server.run()
    return server


if __name__ == "__main__":
    run_server(sys.argv[1] if len(sys.argv) > 1 else "dist_sync")
