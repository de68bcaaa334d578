"""Faults planted under the harness for its tests: each patches the port
so that its timed path breaks in one way.  ``patch`` is ``setattr`` (in a
spawned rank) or pytest's ``monkeypatch.setattr``."""
from __future__ import annotations


def unchanged(patch=setattr):
    """A step that returns its state unchanged."""
    from repro_torch.core import trainer

    real = trainer.lda_iteration

    def step(cfg, shard, state, *args, **kw):
        _, stats = real(cfg, shard, state, *args, **kw)
        return state._replace(iteration=state.iteration + 1), stats

    patch(trainer, "lda_iteration", step)


def _sweep_fault(patch, change):
    from repro_torch.kernels.lda_sample import ops

    real = ops.lda_sample

    def sweep(tile_word, token_doc, token_mask, z, *args, **kw):
        z_new, stats = real(tile_word, token_doc, token_mask, z, *args, **kw)
        return change(z, z_new, token_mask), stats

    patch(ops, "lda_sample", sweep)


def half(patch=setattr):
    """The sweep leaves the second half of the tiles out."""
    def change(z, z_new, mask):
        n = z.shape[0]
        z_new = z_new.clone()
        z_new[n // 2:] = z[n // 2:]
        return z_new
    _sweep_fault(patch, change)


def altered(patch=setattr, num_topics=64):
    """The sweep writes one token's topic K / 2 away from its draw."""
    def change(z, z_new, mask):
        z_new = z_new.clone()
        i = int(mask.reshape(-1).nonzero()[0])
        flat = z_new.reshape(-1)
        flat[i] = (flat[i] + num_topics // 2) % num_topics
        return z_new
    _sweep_fault(patch, change)


def no_exchange(patch=setattr):
    """Each rank adds its own phi delta: the sync is left out."""
    from repro_torch.core import sync

    def keep(delta, *args, **kw):
        return delta

    patch(sync, "sync_phi_delta", keep)


def prior(patch=setattr):
    """The program samples and scores under another prior: alpha doubled
    where it resolves it."""
    from repro_torch.core import trainer

    real = trainer.LDAConfig.resolved_alpha

    def doubled(self):
        return 2 * real(self)

    patch(trainer.LDAConfig, "resolved_alpha", doubled)
