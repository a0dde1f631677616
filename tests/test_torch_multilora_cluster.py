"""Multi-LoRA across processes: the port's adapter registry over its
runtime's object store and the head's directory, and adapters served
through cluster Serve, against ray_tpu's.

Registry: one sequence runs under each package's own runtime
(``init(num_cpus=2)``) with that package's ``AdapterRegistry``:
publishes from the driver, fetches from a task and from an actor (the
keep window's reclaimed version and an unknown adapter raise
``KeyError`` there too), two back-to-back publishes inside one task,
``list()`` and the ``rtpu_llm_lora_publishes_total`` series as the head
merges it. Versions, payload checksums, metadata keys and raised errors
must be equal.

Serve: each package deploys one OpenAI app under its own cluster Serve
(one after the other) on the same weights (the reference's seeded init,
carried to the port with ``models/convert.params_from_numpy``, f32 on
the CPU): model ``tiny`` merges an ``.npz`` adapter from ``lora_dir``
(the reference's ``test_lora_multiplexed_serving``), model ``mlt`` has a
slot table and resolves adapters the driver publishes (the shape of the
reference's ``test_substrate_train_publish_serve_hot_swap``, with
published random adapters in the place of ``LoRATrainer``). Requests go
over HTTP; greedy text must be equal and chosen-token logprobs within
1e-4. A v1 publish serves after the refresh TTL with the same replica.
An unknown adapter raises through the handle in both packages; over the
port's HTTP proxy it is a typed 400. Last, ``@serve.multiplexed``
routing by ``multiplexed_model_id`` under the port's cluster Serve, its
loader fetching published adapters.

Remote functions, classes and deployments are defined inside function
bodies (pickled by value): a worker never imports this module.
"""
import json
import socket
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

SHAPE = dict(vocab_size=258, max_seq_len=256)
ENGINE = dict(max_batch_size=4, page_size=8, num_pages=64,
              max_pages_per_seq=16, chunk_size=16)
NS = "t-cluster"
APP = "mlora"
PROMPT = "hello world"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _adapters(n_seeds=(7, 9, 11), rank=4, alpha=64.0,
              targets=("wq", "wv", "lm_head")) -> list:
    """The reference's random adapters as numpy dicts (both registries
    store the same arrays)."""
    import jax

    from ray_tpu.llm import lora as jlora
    from ray_tpu.models import llama as jllama
    cfg = jllama.llama_tiny(**SHAPE)
    return [{k: np.asarray(v) for k, v in jlora.random_adapter(
        jax.random.PRNGKey(s), cfg, rank=rank, alpha=alpha,
        targets=targets).items()} for s in n_seeds]


def _checksum(ad: dict) -> float:
    return float(sum(np.asarray(ad[k], np.float64).sum() for k in sorted(ad)
                     if k.endswith((".A", ".B"))))


# ------------------------------------------------------------------ #
# the registry under each package's runtime
# ------------------------------------------------------------------ #

def _registry_sequence(pkg, Registry, metrics, adapters) -> dict:
    """One registry life under ``pkg``'s runtime; returns what each
    step gave."""
    for p in _packages():
        if p.is_initialized():
            p.shutdown()
    pkg.init(num_cpus=2, object_store_memory=256 * 1024 * 1024)
    try:
        out = {}
        reg = Registry(NS, keep=2)
        out["clustered"] = reg._clustered()
        out["driver_versions"] = [reg.publish("ad", a) for a in adapters]
        out["latest"] = reg.latest_version("ad")

        def fetched(reg, aid, version):
            try:
                v, ad = reg.fetch(aid, version)
            except KeyError as e:
                return ["KeyError", str(e)]
            return [v, sorted(ad), float(sum(
                np.asarray(ad[k], np.float64).sum() for k in sorted(ad)
                if k.endswith((".A", ".B"))))]

        @pkg.remote
        def fetch(Registry, aid, version):
            return fetched(Registry(NS, keep=2), aid, version)

        @pkg.remote
        def publish_twice(Registry, aid, a, b):
            reg = Registry(NS, keep=2)
            return [reg.publish(aid, a), reg.publish(aid, b)]

        @pkg.remote
        class Reader:
            def __init__(self, Registry):
                self.reg = Registry(NS, keep=2)

            def clustered(self):
                return self.reg._clustered()

            def fetch(self, aid, version=None):
                return fetched(self.reg, aid, version)

        out["task"] = pkg.get([fetch.remote(Registry, aid, v) for aid, v in (
            ("ad", None), ("ad", 1), ("ad", 0), ("missing", None))],
            timeout=120)
        reader = Reader.remote(Registry)
        out["actor_clustered"] = pkg.get(reader.clustered.remote(),
                                         timeout=120)
        out["actor"] = [pkg.get(reader.fetch.remote("ad"), timeout=60)]
        out["driver_versions"].append(reg.publish("ad", adapters[0]))
        out["actor"] += pkg.get([reader.fetch.remote("ad", v)
                                 for v in (None, 1, 2)], timeout=60)
        out["worker_versions"] = pkg.get(publish_twice.remote(
            Registry, "wk", adapters[1], adapters[2]), timeout=120)
        # the worker's directory merges are fire-and-forget: another
        # process sees them once the head has read the frames
        deadline = time.monotonic() + 10
        while reg.latest_version("wk") != 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        out["worker_latest_seen"] = reg.latest_version("wk")
        out["actor_wk"] = pkg.get(reader.fetch.remote("wk"), timeout=60)
        meta = reg.list()
        out["list"] = {aid: {k: (v if k != "ts" else "ts")
                             for k, v in sorted(m.items())}
                       for aid, m in sorted(meta.items())}

        # the publishes series as the head merges it (workers flush every
        # ~2 s)
        def publishes():
            text = "\n".join(metrics.prometheus_lines(
                metrics.collect_store()))
            for ln in text.splitlines():
                if ln.startswith("rtpu_llm_lora_publishes_total{") and \
                        f'namespace="{NS}"' in ln:
                    return float(ln.rsplit(" ", 1)[1])
            return 0.0
        deadline = time.monotonic() + 20
        while publishes() < 6 and time.monotonic() < deadline:
            time.sleep(0.2)
        out["publishes"] = publishes()
        return out
    finally:
        pkg.shutdown()


def _packages():
    import ray_tpu
    import ray_tpu_torch
    return ray_tpu, ray_tpu_torch


@pytest.fixture(scope="module")
def registry_runs():
    """(reference run, port run) of the registry sequence."""
    import ray_tpu
    import ray_tpu_torch
    from ray_tpu.llm.multilora import AdapterRegistry as JaxRegistry
    from ray_tpu.util import metrics as jmetrics
    from ray_tpu_torch.llm.multilora import AdapterRegistry
    from ray_tpu_torch.util import metrics
    adapters = _adapters()
    jmetrics._reset_registry()
    metrics._reset_registry()
    ref = _registry_sequence(ray_tpu, JaxRegistry, jmetrics, adapters)
    port = _registry_sequence(ray_tpu_torch, AdapterRegistry, metrics,
                              adapters)
    return ref, port, adapters


def test_registry_publish_fetch_across_processes(registry_runs):
    """Publishes from the driver resolve in a task's and an actor's
    process; the keep window reclaims, an unknown adapter raises; every
    answer equals the reference registry's under its runtime."""
    ref, port, adapters = registry_runs
    sums = [_checksum(a) for a in adapters]
    assert port["clustered"] and port["actor_clustered"]
    assert port["driver_versions"] == [0, 1, 2, 3]
    assert port["latest"] == 2
    latest, v1, v0, missing = port["task"]
    assert latest[:2] == [2, sorted(adapters[2])] and latest[2] == sums[2]
    assert v1[0] == 1 and v1[2] == sums[1]
    assert v0[0] == "KeyError" and "not fetchable" in v0[1]
    assert missing[0] == "KeyError" and "not in registry" in missing[1]
    assert [a[0] for a in port["actor"]] == [2, 3, "KeyError", 2]
    assert port["actor"][1][2] == sums[0]
    assert port == {k: ref[k] for k in port}


def test_registry_back_to_back_publishes_from_a_worker(registry_runs):
    """Two publishes in a row from one worker give versions 0 and 1 (the
    fire-and-forget merge rides the connection ahead of the next query);
    the driver and an actor then resolve 1."""
    ref, port, adapters = registry_runs
    assert port["worker_versions"] == [0, 1] == ref["worker_versions"]
    assert port["worker_latest_seen"] == 1 == ref["worker_latest_seen"]
    assert port["actor_wk"][0] == 1
    assert port["actor_wk"][2] == _checksum(adapters[2])
    assert port["actor_wk"] == ref["actor_wk"]


def test_registry_list_and_publishes_series(registry_runs):
    """``list()`` names every adapter with the reference's metadata, and
    the head's merged store counts every publish, the worker's too."""
    ref, port, _ = registry_runs
    assert sorted(port["list"]) == ["ad", "wk"]
    assert port["list"]["ad"] == {
        "alpha": 64.0, "rank": 4, "targets": ["lm_head", "wq", "wv"],
        "ts": "ts", "version": 3}
    assert port["list"] == ref["list"]
    assert port["publishes"] == 6.0 == ref["publishes"]


# ------------------------------------------------------------------ #
# adapters through cluster Serve
# ------------------------------------------------------------------ #

def _post(port, body, path="v1/completions", timeout=300):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/{APP}/{path}",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        raw = e.read()
        try:
            return e.code, json.loads(raw)
        except ValueError:
            return e.code, raw.decode(errors="replace")


def _completion(port, model):
    code, resp = _post(port, {"model": model, "prompt": PROMPT,
                              "max_tokens": 8, "logprobs": 1})
    assert code == 200, (model, code, resp)
    choice = resp["choices"][0]
    return {"text": choice["text"], "finish": choice["finish_reason"],
            "logprobs": choice["logprobs"]["token_logprobs"]}


def _serve_session(pkg, serve, Registry, app, adapters,
                   extra=None) -> dict:
    """Deploy ``app`` under ``pkg``'s cluster Serve, publish the tenants
    (``adapters``: tenant-a v0, tenant-b, tenant-a v1) from this driver
    and send every request of the gate; ``extra(port)`` runs more checks
    on the live cluster."""
    for p in _packages():
        if p.is_initialized():
            p.shutdown()
    pkg.init(num_cpus=2, object_store_memory=256 * 1024 * 1024)
    try:
        for attempt in range(5):
            port = _free_port()
            try:
                h = serve.run(app, name=APP, http_port=port)
                break
            except Exception as e:  # noqa: BLE001 — a lost bind retries
                if "address already in use" not in str(e).lower() or \
                        attempt == 4:
                    raise
                serve.shutdown()
        ad_a0, ad_b, ad_a1 = adapters
        reg = Registry("mlt")
        out = {"published": [reg.publish("tenant-a", ad_a0),
                             reg.publish("tenant-b", ad_b)]}
        for model in ("tiny", "tiny:myadapter", "mlt", "mlt:tenant-a",
                      "mlt:tenant-b"):
            out[model] = _completion(port, model)
        errors = {}
        for model in ("tiny:missing", "mlt:never-published"):
            try:
                h.options(method_name="v1_completions").remote(
                    {"model": model, "prompt": "x", "max_tokens": 2}
                ).result(timeout_s=120)
                errors[model] = None
            except Exception as e:  # noqa: BLE001 — recorded, compared
                errors[model] = (isinstance(e, ValueError),
                                 isinstance(e, FileNotFoundError))
        out["handle_errors"] = errors
        out["http_unknown"] = _post(port, {"model": "mlt:never-published",
                                           "prompt": "x", "max_tokens": 2},
                                    timeout=60)
        # hot swap: v1 of tenant-a, no redeploy
        out["published"].append(reg.publish("tenant-a", ad_a1))
        time.sleep(0.6)                 # > cfg.llm_lora_refresh_s
        out["mlt:tenant-a v1"] = _completion(port, "mlt:tenant-a")
        out["mlt after"] = _completion(port, "mlt")
        if extra is not None:
            out["extra"] = extra(port)
        return out
    finally:
        serve.shutdown()
        pkg.shutdown()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(reference run, port run): both packages' OpenAI app with a merged
    adapter and a slot table, each under its own cluster Serve."""
    import jax
    import torch

    import ray_tpu
    import ray_tpu_torch
    from ray_tpu import serve as jserve
    from ray_tpu.llm import PagedEngineConfig as JaxPagedConfig
    from ray_tpu.llm import lora as jlora
    from ray_tpu.llm.multilora import AdapterRegistry as JaxRegistry
    from ray_tpu.llm.openai_api import build_openai_app as jax_build
    from ray_tpu.llm.serving import LLMConfig as JaxLLMConfig
    from ray_tpu.models import llama as jllama
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import (LLMConfig, PagedEngineConfig,
                                   build_openai_app)
    from ray_tpu_torch.llm.multilora import AdapterRegistry
    from ray_tpu_torch.models import llama as tllama
    from ray_tpu_torch.models.convert import params_from_numpy

    lora_dir = tmp_path_factory.mktemp("adapters")
    # strong adapter incl. lm_head: random untrained weights sit in an
    # attractor that weak deltas don't dislodge under greedy decode
    jcfg = jllama.llama_tiny(**SHAPE)
    jlora.save_adapter(jlora.random_adapter(
        jax.random.PRNGKey(7), jcfg, rank=4, alpha=64.0,
        targets=("wq", "wv", "lm_head")), str(lora_dir / "myadapter.npz"))
    tenants = _adapters(n_seeds=(21, 22, 23), rank=4, alpha=64.0,
                        targets=("wq", "wv", "lm_head"))

    def configs(LLMConfig, PagedConfig, model):
        return [LLMConfig(model_id="tiny", warmup=False,
                          lora_dir=str(lora_dir), max_loras=2,
                          engine=PagedConfig(model=model, **ENGINE)),
                LLMConfig(model_id="mlt", warmup=False, lora_namespace="mlt",
                          engine=PagedConfig(model=model, max_adapters=4,
                                             lora_rank=8, **ENGINE))]

    ref = _serve_session(ray_tpu, jserve, JaxRegistry, jax_build(configs(
        JaxLLMConfig, JaxPagedConfig, jcfg)), tenants)
    params = params_from_numpy(
        jax.tree.map(np.asarray, jllama.init(jax.random.PRNGKey(0), jcfg)),
        tllama.llama_tiny(**SHAPE), device="cpu")

    def replicas_of_mlt(_port):
        from ray_tpu_torch.serve.api import CONTROLLER_NAME
        ctrl = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        _v, reps = ray_tpu_torch.get(
            ctrl.get_replicas.remote(APP, "llm:mlt"), timeout=60)
        return [r._actor_id for r in reps]

    def extra(port):
        ids = replicas_of_mlt(port)
        return {"replicas": ids, "multiplexed": _multiplexed(
            ray_tpu_torch, serve, AdapterRegistry, tenants)}

    # the port's tenant-b is published as torch tensors: the replica's
    # slot table takes them as it takes numpy arrays
    as_tensors = {k: torch.tensor(v) if k.endswith((".A", ".B")) else v
                  for k, v in tenants[1].items()}
    port = _serve_session(ray_tpu_torch, serve, AdapterRegistry,
                          build_openai_app(configs(
                              LLMConfig, PagedEngineConfig,
                              tllama.llama_tiny(**SHAPE)),
                              params_refs=[params, params], device="cpu"),
                          [tenants[0], as_tensors, tenants[2]], extra=extra)
    return ref, port, tenants


def _same(a: dict, b: dict):
    assert a["text"] == b["text"] and a["finish"] == b["finish"]
    np.testing.assert_allclose(a["logprobs"], b["logprobs"], atol=1e-4)


def test_merged_lora_dir_adapter_through_cluster_serve(served):
    """``tiny:myadapter`` merges the ``.npz`` adapter under ``lora_dir``
    in the replica: its greedy text equals the reference app's and
    differs from base; a missing adapter raises in both packages."""
    ref, port, _ = served
    assert len(port["tiny:myadapter"]["text"]) > 0
    assert port["tiny:myadapter"]["text"] != port["tiny"]["text"]
    for model in ("tiny", "tiny:myadapter"):
        _same(port[model], ref[model])
    assert port["handle_errors"]["tiny:missing"] is not None
    assert ref["handle_errors"]["tiny:missing"] is not None
    assert port["handle_errors"]["tiny:missing"] == \
        ref["handle_errors"]["tiny:missing"]


def test_published_adapters_serve_and_hot_swap(served):
    """The driver publishes; the replica in another process resolves and
    serves each tenant from its slot table with the reference's tokens
    (tenant-b's payload holds torch tensors in the port's run, numpy
    arrays in the reference's); a v1 publish serves after the TTL from
    the same replica; base traffic is unchanged throughout."""
    ref, port, _ = served
    assert port["published"] == [0, 0, 1] == ref["published"]
    for model in ("mlt", "mlt:tenant-a", "mlt:tenant-b",
                  "mlt:tenant-a v1", "mlt after"):
        _same(port[model], ref[model])
    assert port["mlt:tenant-a"]["text"] != port["mlt"]["text"]
    assert port["mlt:tenant-b"]["text"] != port["mlt:tenant-a"]["text"]
    assert port["mlt:tenant-a v1"]["text"] != port["mlt:tenant-a"]["text"]
    assert port["mlt after"] == port["mlt"]
    # base rows through the slot table = the plain engine's
    assert port["mlt"]["text"] == port["tiny"]["text"]
    # no redeploy: one replica, the same one after the swap
    assert len(port["extra"]["replicas"]) == 1


def test_unknown_adapter_is_a_typed_error(served):
    """An adapter never published: ``ValueError`` through the handle in
    both packages; over the port's proxy a 400 naming the adapter, not a
    bare 500."""
    ref, port, _ = served
    assert port["handle_errors"]["mlt:never-published"] == (True, False)
    assert ref["handle_errors"]["mlt:never-published"] == (True, False)
    code, body = port["http_unknown"]
    assert code == 400, body
    assert body["error"] == "invalid_request"
    assert "never-published" in body["detail"]


def _multiplexed(pkg, serve, Registry, adapters) -> dict:
    """``@serve.multiplexed`` over two replicas: the loader fetches the
    published adapter named by the request's ``multiplexed_model_id``."""
    reg = Registry("mux")
    for i, ad in enumerate(adapters):
        reg.publish(f"m{i}", ad)

    @serve.deployment(num_replicas=2)
    class AdapterHost:
        def __init__(self, Registry):
            import os
            self.reg = Registry("mux")
            self.loads = []
            self.pid = os.getpid()

        @serve.multiplexed(max_num_models_per_replica=3)
        async def get_model(self, model_id):
            self.loads.append(model_id)
            return self.reg.fetch(model_id)

        async def __call__(self, _x=None):
            v, ad = await self.get_model()
            return [serve.get_multiplexed_model_id(), v, self.pid,
                    float(sum(np.asarray(ad[k], np.float64).sum()
                              for k in sorted(ad)
                              if k.endswith((".A", ".B"))))]

        async def load_log(self):
            return [self.pid, list(self.loads)]

    h = serve.run(AdapterHost.bind(Registry), name="mux",
                  route_prefix="/mux")
    calls = [h.options(multiplexed_model_id=f"m{i % 3}").remote(i)
             .result(timeout_s=60) for i in range(9)]
    from ray_tpu_torch.serve.api import CONTROLLER_NAME
    ctrl = pkg.get_actor(CONTROLLER_NAME)
    _v, replicas = pkg.get(ctrl.get_replicas.remote("mux", "AdapterHost"),
                           timeout=60)
    logs = dict(pkg.get([r.handle_request.remote("load_log", (), {}, None)
                         for r in replicas], timeout=60))
    serve.delete("mux")
    return {"calls": calls, "logs": logs}


def test_multiplexed_routing_by_model_id(served):
    """Under the port's cluster Serve, ``multiplexed_model_id`` routes
    every request for one id to one replica, whose loader fetched that
    adapter from the registry once."""
    _ref, port, adapters = served
    mux = port["extra"]["multiplexed"]
    pid_of = {}
    for model_id, version, pid, checksum in mux["calls"]:
        assert version == 0
        assert checksum == _checksum(adapters[int(model_id[1:])])
        assert pid_of.setdefault(model_id, pid) == pid
    assert sorted(pid_of) == ["m0", "m1", "m2"]
    for model_id, pid in pid_of.items():
        assert mux["logs"][pid].count(model_id) == 1, mux["logs"]
