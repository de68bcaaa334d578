"""The port's serving path (repro_torch.serve, repro_torch.launch.serve_lda)
on the CPU, held against the JAX package where both compute the same thing.

* Whole dense path: the JAX ``fold_in`` with a key, and the port's
  ``fold_in`` fed that key's ``draw_fold_in_randoms`` output as data.
  theta within atol 1e-6 (float32 normalisation), ``top_topics`` exact
  (ties included), ``sparse_frac``/``mean_s_over_sq`` within rtol 1e-5.
* Snapshots cross between the packages in both directions.
* The engine serves a planted model; faults, OOV ids and HTTP behave as in
  the JAX engine.
"""
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.fold_in import ops as jops
from repro.serve import ModelSnapshot as JSnapshot
from repro.serve import load_snapshot as jload
from repro.serve import save_snapshot as jsave
from repro.serve.infer import fold_in as jfold_in
from repro_torch.serve import (EngineConfig, FaultPlan, HotSwapModel,
                               InferConfig, LDAServeEngine,
                               heldout_perplexity, load_snapshot,
                               save_snapshot, snapshot_from_numpy)
from repro_torch.serve.infer import (fold_in, fold_in_config, fold_in_request,
                                     pack_docs, pack_request_buffer)

K, V, WORDS_PER_TOPIC = 8, 64, 8


def planted_phi(K=K, V=V, soft=False):
    """Topic k owns words [k*8, (k+1)*8) (the JAX serving tests' model);
    ``soft`` adds background mass on every word."""
    phi = np.full((V, K), 10 if soft else 0, np.int32)
    for k in range(min(K, V // WORDS_PER_TOPIC)):
        phi[k * WORDS_PER_TOPIC:(k + 1) * WORDS_PER_TOPIC, k] += 200
    return phi


def port_snapshot(phi, alpha=0.1, beta=0.01):
    return snapshot_from_numpy(phi, phi.sum(0), alpha, beta, phi.shape[0],
                               device="cpu")


def planted_docs(num_docs, doc_len, seed=0, n_topics=K):
    rng = np.random.default_rng(seed)
    docs, majors = [], []
    for _ in range(num_docs):
        a, b = rng.choice(n_topics, size=2, replace=False)
        mix = rng.choice([a, b], size=doc_len, p=[0.75, 0.25])
        words = mix * WORDS_PER_TOPIC + rng.integers(0, WORDS_PER_TOPIC,
                                                     doc_len)
        docs.append(words.astype(np.int32))
        majors.append(int(a))
    return docs, np.asarray(majors)


@pytest.fixture(scope="module")
def snap():
    return port_snapshot(planted_phi())


def _engine(snap, **kw):
    infer = InferConfig(burn_in=kw.pop("burn_in", 3),
                        samples=kw.pop("samples", 2))
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_delay_ms", 30.0)
    kw.setdefault("length_buckets", (32, 64))
    return LDAServeEngine(HotSwapModel(snap), EngineConfig(infer=infer, **kw))


# ---------------------------------------------------------------------------
# whole dense path against the JAX package
# ---------------------------------------------------------------------------
def _random_model(Kt, Vt, seed):
    rng = np.random.default_rng(seed)
    return ((rng.random((Vt, Kt)) < 0.15)
            * rng.integers(1, 400, (Vt, Kt))).astype(np.int32)


@pytest.mark.parametrize("Kt,ell", [(96, None), (256, None), (96, 8)])
def test_fold_in_matches_jax_fold_in(Kt, ell):
    Vt, B, L, burn_in, samples = 300, 4, 48, 3, 2
    phi = _random_model(Kt, Vt, Kt)
    rng = np.random.default_rng(1)
    docs = [rng.integers(0, Vt, n).astype(np.int32) for n in (48, 17, 30, 1)]
    tokens, mask = pack_docs(docs, L)
    key = jax.random.key(5)
    alpha, beta = 50.0 / Kt, 0.01
    j = jfold_in(jnp.asarray(phi), jnp.asarray(phi.sum(0)), jnp.asarray(tokens),
                 jnp.asarray(mask), key, alpha, beta, num_words_total=Vt,
                 burn_in=burn_in, samples=samples, top_k=8, ell_capacity=ell)
    z0, uni = jops.draw_fold_in_randoms(key, B, L, Kt, burn_in + samples)
    s = port_snapshot(phi, alpha, beta)
    t = fold_in(s.phi_vk, s.phi_sum, tokens, mask,
                (np.array(z0), np.array(uni)), alpha, beta,
                num_words_total=Vt, burn_in=burn_in, samples=samples,
                top_k=8, ell_capacity=ell)
    np.testing.assert_allclose(np.asarray(j.theta), t.theta.numpy(),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(np.asarray(j.top_topics),
                                  t.top_topics.numpy())
    np.testing.assert_allclose(np.asarray(j.top_weights),
                               t.top_weights.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(j.sparse_frac), float(t.sparse_frac),
                               rtol=1e-5)
    np.testing.assert_allclose(float(j.mean_s_over_sq),
                               float(t.mean_s_over_sq), rtol=1e-5)


def test_top_topics_break_float_ties_like_lax_top_k():
    """Topics with equal counts get bit-equal theta; the order is then by
    topic id, as lax.top_k orders them."""
    from repro_torch.serve.infer import _assemble

    tsum = torch.tensor([[0, 3, 0, 3, 1, 0], [2, 2, 2, 2, 2, 2]],
                        dtype=torch.int32)
    res = _assemble(tsum, torch.tensor(0), torch.tensor(0.0), 0.1, 1, 6,
                    torch.tensor(1.0))
    tw, tt = jax.lax.top_k(jnp.asarray(res.theta.numpy()), 6)
    np.testing.assert_array_equal(np.asarray(tt), res.top_topics.numpy())
    assert res.top_topics[0].tolist() == [1, 3, 4, 0, 2, 5]


# ---------------------------------------------------------------------------
# snapshots cross between the packages
# ---------------------------------------------------------------------------
def test_jax_snapshot_loads_in_port(tmp_path):
    phi = planted_phi(soft=True)
    js = JSnapshot(phi_vk=jnp.asarray(phi), phi_sum=jnp.asarray(phi.sum(0)),
                   alpha=0.3, beta=0.05, num_words_total=V + 3,
                   meta={"iteration": 7},
                   vocab=tuple(f"w{v}" for v in range(V)))
    p = jsave(str(tmp_path / "jax.npz"), js)
    ts = load_snapshot(p, device="cpu")
    np.testing.assert_array_equal(ts.phi_vk.numpy(), phi)
    np.testing.assert_array_equal(ts.phi_sum.numpy(), phi.sum(0))
    assert ts.phi_vk.dtype == torch.int32
    assert (ts.alpha, ts.beta, ts.num_words_total) == (0.3, 0.05, V + 3)
    assert ts.meta["iteration"] == 7 and ts.vocab == js.vocab
    assert ts.topic_words(0, 3) == js.topic_words(0, 3)


def test_port_snapshot_loads_in_jax(tmp_path):
    phi = planted_phi(soft=True)
    ts = snapshot_from_numpy(phi, phi.sum(0), 0.2, 0.01, V,
                             meta={"source": "port"}, device="cpu")
    p = save_snapshot(str(tmp_path / "port.npz"), ts)
    js = jload(p)
    np.testing.assert_array_equal(np.asarray(js.phi_vk), phi)
    np.testing.assert_array_equal(np.asarray(js.phi_sum), phi.sum(0))
    assert (js.alpha, js.beta, js.num_words_total) == (0.2, 0.01, V)
    assert js.meta["source"] == "port" and js.vocab is None
    back = load_snapshot(p, device="cpu")
    assert torch.equal(back.phi_vk, ts.phi_vk)


def test_snapshot_from_numpy_of_jax_arrays_folds_in_identically():
    phi = _random_model(96, 200, 3)
    js = JSnapshot(phi_vk=jnp.asarray(phi), phi_sum=jnp.asarray(phi.sum(0)),
                   alpha=0.5, beta=0.01, num_words_total=200)
    ts = snapshot_from_numpy(np.asarray(js.phi_vk), np.asarray(js.phi_sum),
                             js.alpha, js.beta, js.num_words_total,
                             device="cpu")
    rng = np.random.default_rng(0)
    tokens, mask = pack_docs([rng.integers(0, 200, n) for n in (20, 40)])
    cfg = InferConfig(burn_in=3, samples=2)
    key = jax.random.key(0)
    j = jfold_in(js.phi_vk, js.phi_sum, jnp.asarray(tokens), jnp.asarray(mask),
                 key, js.alpha, js.beta, num_words_total=200, burn_in=3,
                 samples=2)
    z0, uni = jops.draw_fold_in_randoms(key, *tokens.shape, 96, 5)
    t = fold_in_config(ts, tokens, mask, (np.array(z0), np.array(uni)),
                       cfg)
    np.testing.assert_array_equal(np.asarray(j.top_topics),
                                  t.top_topics.numpy())
    np.testing.assert_allclose(np.asarray(j.theta), t.theta.numpy(),
                               atol=1e-6, rtol=0)


def test_hot_swap_double_buffer(snap):
    model = HotSwapModel(snap)
    v0, s0 = model.acquire()
    assert v0 == 1 and s0 is snap
    shifted = port_snapshot(planted_phi() + 1)
    assert model.publish(shifted) == 2
    assert model.acquire()[1] is shifted
    assert int(s0.phi_vk.sum()) == int(snap.phi_vk.sum())


def test_hyper_staged_on_snapshot_device(snap):
    assert snap.hyper.device == snap.phi_vk.device
    assert snap.hyper.dtype == torch.float32
    assert snap.hyper.tolist() == pytest.approx([snap.alpha, snap.beta])


# ---------------------------------------------------------------------------
# fold-in behaviour
# ---------------------------------------------------------------------------
def test_recovers_planted_mixture(snap):
    docs, majors = planted_docs(24, 48, seed=3)
    tokens, mask = pack_docs(docs)
    res = fold_in_config(snap, tokens, mask, torch.Generator().manual_seed(0),
                         InferConfig(burn_in=8, samples=4))
    assert (res.theta.argmax(1).numpy() == majors).mean() >= 0.9
    np.testing.assert_allclose(res.theta.sum(1).numpy(), 1.0, rtol=1e-5)
    assert 0.0 < float(res.sparse_frac) <= 1.0
    assert 0.0 < float(res.mean_s_over_sq) <= 1.0


def test_oov_tokens_raise_before_the_gather(snap):
    tokens, mask = pack_docs([np.array([1, 2, V], np.int32)])
    with pytest.raises(ValueError, match="word ids"):
        fold_in_config(snap, tokens, mask, torch.Generator().manual_seed(0),
                       InferConfig())
    tokens[0, 2] = -1
    with pytest.raises(ValueError, match="word ids"):
        fold_in_config(snap, tokens, mask, torch.Generator().manual_seed(0),
                       InferConfig())
    # anything goes under mask=False
    mask[0, 2] = False
    fold_in_config(snap, tokens, mask, torch.Generator().manual_seed(0),
                   InferConfig(burn_in=1, samples=1))


def test_fold_in_request_buffer_equals_fold_in(snap):
    """The packed-buffer path (engine unit) gives the fold-in of the same
    tokens under the generator seeded from the buffer's seed."""
    docs, _ = planted_docs(3, 20, seed=4)
    cfg = InferConfig(burn_in=3, samples=2)
    buf = torch.from_numpy(pack_request_buffer(docs, 4, 32, seed=77))
    a = fold_in_request(snap, buf, cfg)              # seed read from buf
    b = fold_in_request(snap, buf, cfg, seed=77)
    tokens, mask = pack_docs(docs + [np.zeros(0, np.int32)], 32)
    c = fold_in_config(snap, tokens, mask, torch.Generator().manual_seed(77),
                       cfg)
    for x, y in ((a, b), (a, c)):
        assert torch.equal(x.theta, y.theta)
        assert torch.equal(x.top_topics, y.top_topics)


def test_heldout_perplexity_finite_and_below_uniform():
    soft = port_snapshot(planted_phi(soft=True))
    docs, _ = planted_docs(24, 60, seed=9)
    few = heldout_perplexity(soft, docs, InferConfig(burn_in=0, samples=1))
    more = heldout_perplexity(soft, docs, InferConfig(burn_in=12, samples=6))
    assert np.isfinite(more.perplexity) and more.perplexity < V
    assert more.perplexity < few.perplexity
    assert more.num_docs == 24 and more.num_tokens == 24 * 30


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------
def test_engine_serves_planted_model(snap):
    eng = _engine(snap, burn_in=8, samples=4)
    try:
        docs, majors = planted_docs(16, 40, seed=11)
        out = eng.infer_many(docs)
        got = np.asarray([r["theta"].argmax() for r in out])
        assert (got == majors).mean() >= 0.9
        s = eng.stats()
        assert s["requests"] == 16 and s["h2d_transfers"] == s["batches"]
        assert s["p99_ms"] >= s["p50_ms"] > 0
        assert all(r["model_version"] == 1 for r in out)
    finally:
        eng.stop()


def test_engine_bucketing_bounds_launched_shapes(snap):
    eng = _engine(snap, max_batch=4, max_delay_ms=150.0)
    try:
        eng.infer_many([np.arange(10, dtype=np.int32)] * 4)
        c0 = eng.jit_cache_size()
        assert c0 == 1
        eng.infer_many([np.arange(20, dtype=np.int32)] * 4)
        assert eng.jit_cache_size() == c0
        eng.infer_many([np.arange(50, dtype=np.int32)] * 4)
        assert eng.jit_cache_size() == c0 + 1
        assert eng.stats()["jit_cache_size"] == c0 + 1
    finally:
        eng.stop()


def test_engine_hot_swap_changes_answers(snap):
    eng = _engine(snap, max_batch=2, max_delay_ms=20.0)
    try:
        doc = np.arange(0, 8, dtype=np.int32)          # pure topic-0 words
        r1 = eng.infer(doc)
        assert r1["model_version"] == 1 and int(r1["theta"].argmax()) == 0
        rolled = np.roll(planted_phi(), -WORDS_PER_TOPIC, axis=0)
        eng.model.publish(port_snapshot(rolled))
        r2 = eng.infer(doc)
        assert r2["model_version"] == 2 and int(r2["theta"].argmax()) == 1
    finally:
        eng.stop()


def test_engine_rejects_oov_and_truncates(snap):
    eng = _engine(snap)
    try:
        with pytest.raises(ValueError, match="word ids"):
            eng.submit(np.array([1, V], np.int32))
        r = eng.infer(np.zeros(100, np.int32))         # > largest bucket
        assert r["truncated"] is True
    finally:
        eng.stop()


def test_injected_oom_splits_and_serves(snap):
    eng = _engine(snap, max_batch=4, max_delay_ms=100.0, oom_retries=1,
                  oom_backoff_ms=0.5,
                  fault_plan=FaultPlan.parse("device_oom@0x2"))
    try:
        reqs = [eng.submit(np.arange(i, i + 8, dtype=np.int32))
                for i in range(4)]
        hung = sum(0 if r.event.wait(60.0) else 1 for r in reqs)
        assert hung == 0
        assert all("theta" in r.result for r in reqs)
        s = eng.stats()
        assert s["oom_events"] == 2 and s["oom_fallbacks"] == 1
        assert s["batches"] == 2 and s["errors"] == 0
    finally:
        eng.stop()


def test_worker_exception_is_labelled(snap):
    eng = _engine(snap, fault_plan=FaultPlan.parse("worker_exception@0"))
    try:
        with pytest.raises(RuntimeError, match="injected fault"):
            eng.infer(np.arange(8, dtype=np.int32), timeout=30.0)
        assert eng.stats()["errors_by_reason"] == {"exception": 1}
        assert "theta" in eng.infer(np.arange(8, dtype=np.int32), timeout=30.0)
    finally:
        eng.stop()


def test_real_cuda_oom_is_recognised():
    from repro_torch.serve.engine import _is_oom

    assert _is_oom(torch.cuda.OutOfMemoryError("CUDA out of memory."))
    assert not _is_oom(RuntimeError("something else"))


def test_stop_drains_pending_and_refuses_submits(snap):
    from repro_torch.serve.engine import _Request

    eng = _engine(snap)
    eng.stop()
    req = _Request(np.arange(8, dtype=np.int32))
    with eng._cond:
        eng._pending.append(req)
        req.queued = True
    eng.stop()
    assert req.event.is_set() and req.result["reason"] == "shutdown"
    with pytest.raises(RuntimeError, match="engine stopped"):
        eng.submit(np.arange(8, dtype=np.int32))


# ---------------------------------------------------------------------------
# launcher: HTTP surface and bench mode
# ---------------------------------------------------------------------------
def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, json.loads(r.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read()


def test_http_infer_stats_and_oov_400(snap):
    from repro_torch.launch.serve_lda import (build_argparser, make_engine,
                                              make_http_server)

    args = build_argparser().parse_args(
        ["--snapshot", "unused.npz", "--port", "0", "--device", "cpu",
         "--burn-in", "2", "--samples", "1", "--length-buckets", "16"])
    model, engine = make_engine(args, snap)
    httpd = make_http_server(args, model, engine)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        status, out = _post(base + "/infer", {"tokens": list(range(8))})
        assert status == 200 and len(out["theta"]) == K
        assert out["model_version"] == 1
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base + "/infer", {"tokens": [1, 2, V]})
        assert ei.value.code == 400
        assert "word ids" in json.loads(ei.value.read())["error"]
        status, body = _get(base + "/stats")
        stats = json.loads(body)
        assert status == 200 and stats["requests"] == 1
        assert stats["num_topics"] == K and stats["device"] == "cpu"
        status, body = _get(base + "/metrics")
        assert b"repro_serve_requests_total 1" in body
        status, body = _get(base + "/healthz")
        assert status == 200 and json.loads(body)["ok"] is True
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.stop()


def test_bench_plants_serves_and_hot_swaps(tmp_path, capsys):
    from repro_torch.launch import serve_lda

    path = str(tmp_path / "planted.npz")
    rc = serve_lda.main(["--snapshot", path, "--bench", "--device", "cpu",
                         "--vocab", "600", "--topics", "32",
                         "--bench-docs", "16", "--burn-in", "4",
                         "--samples", "2", "--max-batch", "8"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "hot-swapped to model_version=2" in out
    recovered = float(out.split("recovered on ")[1].split()[0])
    assert recovered >= 0.8
    assert load_snapshot(path, device="cpu").meta["planted_seed"] == 0


def test_planted_model_has_known_homes():
    from repro_torch.launch.serve_lda import planted_model

    phi, home = planted_model(500, 16, seed=2, num_tokens=1_000_000)
    assert phi.shape == (500, 16) and phi.dtype == np.int32
    assert (phi.argmax(1) == home).all()
    total = phi.sum(1)
    np.testing.assert_allclose(phi[np.arange(500), home] / total, 0.8,
                               atol=0.34)       # rounding on rare words
    assert (total >= 1).all()
