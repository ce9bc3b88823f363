"""mx.kv — key-value store (port of ``mxnet_tpu/kvstore.py``; reference:
python/mxnet/kvstore.py over src/kvstore/; see ``_kvstore_impl.py``)."""

from ._kvstore_impl import create, KVStoreBase  # noqa: F401
from ._kvstore_impl import (KVStoreLocal, KVStoreNCCL, KVStoreDist,  # noqa
                            KVStoreServer)
from ._kvstore_impl import (RPCTimeoutError, SyncTimeoutError,  # noqa
                            EvictedWorkerError)

# the JAX package's name for its device store
KVStoreTPU = KVStoreNCCL
