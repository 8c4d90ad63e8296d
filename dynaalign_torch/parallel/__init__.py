"""All-pairs similarity across processes joined by ``torch.distributed``:
the mesh, its placements and start-up (:mod:`.mesh`), the sharded MinHash,
NW and top-k functions with their planners (:mod:`.allpairs`), and the clean
abort (:mod:`.failures`).  Importing it starts no process group."""

from .mesh import (  # noqa: F401
    Mesh,
    block_sharded,
    distributed_init,
    make_mesh,
    replicated,
    row_sharded,
)
from .allpairs import (  # noqa: F401
    bucketed_schedule_stats,
    nw_allpairs_schedule_stats,
    plan_bucket_group,
    plan_nw_allpairs,
    sharded_minhash_similarity,
    sharded_minhash_topk,
    sharded_nw_allpairs,
    sharded_nw_allpairs_bucketed,
    sharded_signature_agreement,
)
