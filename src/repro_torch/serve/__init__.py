"""Online LDA inference & serving on PyTorch (the port of ``repro.serve``).

* ``snapshot`` — frozen-model artifact (phi + vocab + hyperparams), the same
  ``.npz`` format as the JAX package, with double-buffered hot-swap.
* ``infer``    — fold-in Gibbs for unseen documents against a frozen phi;
  the sweeps run the CUDA kernel on the card.
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
                                     fold_in_config, pack_docs)
from repro_torch.serve.snapshot import (HotSwapModel, ModelSnapshot,
                                        PublishError, load_snapshot,
                                        save_snapshot, snapshot_from_numpy,
                                        snapshot_from_state)

__all__ = [
    "EngineConfig", "LDAServeEngine", "RejectedError",
    "PerplexityResult", "heldout_perplexity",
    "FaultPlan", "FaultSpec", "InjectedFault",
    "FoldInResult", "InferConfig", "fold_in", "fold_in_config", "pack_docs",
    "HotSwapModel", "ModelSnapshot", "PublishError",
    "load_snapshot", "save_snapshot", "snapshot_from_numpy",
    "snapshot_from_state",
]
