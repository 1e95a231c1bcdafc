"""Device-mesh scale-out: row sharding + cross-shard top-k merge."""

from vectordb_retrieval_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    ShardedTensor,
    host_local_rows,
    init_distributed,
    make_mesh,
    make_multihost_mesh,
)
from vectordb_retrieval_tpu_torch.parallel.sharded import (  # noqa: F401
    shard_database,
    sharded_exact_search,
)
from vectordb_retrieval_tpu_torch.parallel.sharded_graph import (  # noqa: F401
    build_sharded_block_graph,
    build_sharded_graph,
    sharded_block_graph_search,
    sharded_graph_search,
)
from vectordb_retrieval_tpu_torch.parallel.sharded_ivf import (  # noqa: F401
    build_sharded_ivf_coded,
    build_sharded_ivf_flat,
    sharded_ivf_coded_search,
    sharded_ivf_flat_search,
)
