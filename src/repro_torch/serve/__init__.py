"""Online LDA inference & serving on PyTorch (the port of ``repro.serve``).

* ``snapshot`` — frozen-model artifact (phi + vocab + hyperparams), the same
  dense ``.npz`` and V-sharded ``.sharded`` formats as the JAX package,
  with double-buffered hot-swap across both layouts.
* ``infer``    — fold-in Gibbs for unseen documents against a frozen phi,
  dense or word-sharded over several devices (psum or all2all rows); the
  sweeps run the CUDA kernel on the card.
* ``engine``   — continuous-batching request engine: bounded admission
  queue (block/reject/shed policies), per-request deadlines + cancellation,
  SLO-aware flush, shape bucketing, one H2D copy per batch, worker
  supervision, p50/p99 latency counters.
* ``faults``   — deterministic, seedable fault injection.
* ``eval``     — held-out perplexity via the document-completion protocol.
"""
from repro_torch.serve.engine import EngineConfig, LDAServeEngine, RejectedError
from repro_torch.serve.eval import PerplexityResult, heldout_perplexity
from repro_torch.serve.faults import FaultPlan, FaultSpec, InjectedFault
from repro_torch.serve.infer import (FoldInResult, InferConfig, fold_in,
                                     fold_in_config, fold_in_sharded,
                                     pack_docs)
from repro_torch.serve.snapshot import (HotSwapModel, ModelSnapshot,
                                        PublishError, ShardedModelSnapshot,
                                        SnapshotIntegrityError,
                                        assemble_sharded_snapshot,
                                        load_any_snapshot,
                                        load_sharded_snapshot, load_snapshot,
                                        save_sharded_snapshot, save_snapshot,
                                        serving_devices, shard_snapshot,
                                        snapshot_from_numpy,
                                        snapshot_from_state)

__all__ = [
    "EngineConfig", "LDAServeEngine", "RejectedError",
    "PerplexityResult", "heldout_perplexity",
    "FaultPlan", "FaultSpec", "InjectedFault",
    "FoldInResult", "InferConfig", "fold_in", "fold_in_config",
    "fold_in_sharded", "pack_docs",
    "HotSwapModel", "ModelSnapshot", "PublishError", "ShardedModelSnapshot",
    "SnapshotIntegrityError", "assemble_sharded_snapshot",
    "load_any_snapshot", "load_sharded_snapshot", "load_snapshot",
    "save_sharded_snapshot", "save_snapshot", "serving_devices",
    "shard_snapshot", "snapshot_from_numpy", "snapshot_from_state",
]
