"""Prefill/decode disaggregation for the paged serving engine.

The port of ``ray_tpu/llm/pd_disagg.py``. Reference parity:
llm/_internal/serve/deployments/prefill_decode_disagg/
prefill_decode_disagg.py:64 (PDProxyServer — routes each request to a
prefill instance, then streams tokens from a decode instance once the KV
transferred) and :160 (build_app wiring the two replica groups behind one
proxy).

Prefill replicas run only chunked prefill (compute-bound, long
sequences); decode replicas run only batched paged decode
(memory-bandwidth-bound, latency-sensitive). Both dispatch the ragged
paged attention kernel (``ops/csrc/ragged_paged_attention.cu``): the
prefill family in the prefill replica, the decode family in the decode
replica. The prefilled KV pages move between replicas as a host payload
(``PagedInferenceEngine.prefill_export`` / ``import_prefill``; bf16
pages as raw ``np.uint16``, so they travel out of band): over a sealed
ring channel in the shared object store once a decode replica and a
prefill replica are paired, else as an ObjectRef that the decode
replica fetches. Disaggregation protects decode TTFT and inter-token
latency from long-prompt prefill stalls.

What the port changes against the reference:

- Each replica takes ``device`` (default ``"cuda"``, as ``LLMServer``);
  its engine raises when CUDA is absent. The CPU tests pass ``"cpu"``.
- Each role group asks for whole GPUs: ``build_pd_openai_app`` and
  ``build_pd_proxy`` take ``gpus_per_replica`` (default 1; 0 for
  replicas on the CPU) and write ``{"num_gpus": n}`` into both groups'
  actor options. The reference's replicas ask for no accelerator; in the
  port a worker without a lease sees no device.
- ``PrefillReplica`` steps its engine under a lock: Serve runs up to
  ``max_ongoing_requests`` calls of a replica at once, and
  ``prefill_export`` steps the engine from the caller's thread, so two
  prefills would otherwise step one engine from two threads.
- ``PrefillReplica.close_kv_channel`` returns once the decode replica
  has swept the ring (the decode side acks the end after its sweep),
  Serve's controller closes every paired ring before it kills an
  application's replicas, and ``PDServer.completions_stream`` reads the
  decode replica's stream to its end, so no ring object outlives a
  request or the application.

Usage:
    proxy = build_pd_proxy(n_prefill=1, n_decode=1, engine_cfg=cfg)
    out = ray_tpu_torch.get(proxy.generate.remote("hello", SamplingParams()))
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Optional

import torch

from .engine import SamplingParams

#: seconds close_kv_channel waits for the decode replica's sweep
_CLOSE_TIMEOUT_S = 30.0


def _chan_counter(name: str, desc: str):
    from ..util.metrics import Counter, cached_metric
    return cached_metric(Counter, name, desc)


def _shared_store():
    """The process's shared object store, or None when sealed channels
    can't engage (no runtime, local mode, or an own-store node that
    cannot share rings with its peers — same gate as the serve stream
    channel, controller._start_stream_channel)."""
    import os
    if os.environ.get("RTPU_OWN_STORE") == "1":
        return None
    from ..core import runtime as rt_mod
    rt = rt_mod.get_runtime_if_exists()
    return getattr(rt, "store", None)


def _build_engine(engine_cfg, params, rng_seed, device):
    """(engine, device) on ``device``; a params dict is moved there, None
    gives seeded random weights made on the device."""
    from ..models import llama
    from .paged_engine import PagedInferenceEngine
    from .serving import _to_device
    dev = llama.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        # pin the index: every thread that touches the engine makes it
        # current (_device_scope)
        dev = torch.device("cuda", torch.cuda.current_device())
    if params is not None:
        params = _to_device(params, dev)
    return PagedInferenceEngine(engine_cfg, params=params,
                                rng_seed=rng_seed, device=dev), dev


def _device_scope(device: torch.device):
    """Make ``device`` current in this thread (a new thread starts on
    device 0)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class PrefillReplica:
    """Owns a paged engine used exclusively for prefill; returns the KV
    payload (pages + first sampled token) instead of decoding."""

    def __init__(self, engine_cfg, params=None, rng_seed: int = 0,
                 warmup: bool = True, device="cuda"):
        self.engine, self.device = _build_engine(engine_cfg, params,
                                                 rng_seed, device)
        # one engine step at a time: concurrent calls of this replica
        # (Serve's max_ongoing_requests, an actor's max_concurrency)
        # each drive the engine loop from their own thread
        self._steplock = threading.Lock()
        # the KV ring has one sequential producer: concurrent calls seal
        # their payloads one at a time
        self._writelock = threading.Lock()
        if warmup:
            # prefill-only replica: never dispatches decode/verify
            with _device_scope(self.device):
                self.engine.warmup(families=("prefill",))
        self._kv_writer = None

    def _export(self, prompt, params: SamplingParams) -> dict:
        """``engine.prefill_export`` with every step under the lock:
        concurrent prefills share the engine's batches, one dispatch at a
        time."""
        eng = self.engine
        with _device_scope(self.device):
            with self._steplock:
                req = eng.submit(prompt, params)
                req.prefill_only = True
            while req.export_payload is None and not req.done:
                with self._steplock:
                    if req.export_payload is None and not req.done:
                        eng.step()
        if req.export_payload is None:
            raise RuntimeError("prefill finished without an export "
                               "(prompt rejected?)")
        return req.export_payload

    def prefill(self, prompt, params: Optional[SamplingParams] = None):
        """Run chunked prefill; returns the exported KV payload dict
        {prompt_ids, pages: per-layer {k,v} host arrays, first_token,
        page_size, page_hashes, prefix_salt}."""
        return self._export(prompt, params or SamplingParams())

    def prefill_ref(self, prompt, params: Optional[SamplingParams] = None):
        """Like prefill(), but parks the payload in the object store and
        returns only its ObjectRef — the KV bytes then move store-to-store
        to whichever decode replica receives the ref."""
        import ray_tpu_torch
        return ray_tpu_torch.put(self.prefill(prompt, params))

    # -- sealed-channel KV handoff (dag/channel.py ring; the replica is
    # the ring's single sequential producer) -------------------------------

    def connect_kv_channel(self, spec: dict) -> bool:
        """Attach this replica as the producer of a paired decode
        replica's KV ring (spec from DecodeReplica.open_kv_channel).
        After this, prefill_chan() hands finished KV payloads over with
        no control dispatch: the payload is sealed into shm and the
        decode replica's drain thread imports it. Returns False when no
        shared store is available (caller falls back to actor-call
        handoff)."""
        store = _shared_store()
        if store is None or not spec:
            return False
        from ..core.ids import ObjectID
        from ..dag.channel import RingWriter
        self._kv_writer = RingWriter(store, spec["base"],
                                     ObjectID(spec["stop"]),
                                     int(spec["ring"]))
        return True

    def prefill_chan(self, prompt, cid,
                     params: Optional[SamplingParams] = None) -> Any:
        """Chunked-prefill `prompt` and stream its KV payload to the
        paired decode replica over the sealed ring; `cid` is the
        caller's correlation id (results surface on the decode side
        keyed by it). Credit backpressure runs BEFORE prefill: when the
        decoder's ring is full, admission parks here — a slow decoder
        throttles prefill instead of ballooning the store with payloads
        nobody is importing yet. A payload the store cannot hold raises
        (``ObjectStoreFullError``)."""
        w = self._kv_writer
        if w is None:
            raise RuntimeError("connect_kv_channel() first")
        from ..dag.channel import ChannelClosed
        stalls = _chan_counter(
            "rtpu_llm_pd_chan_credit_stalls_total",
            "prefill admissions parked on decode-ring credit")
        while not w.credit_ready():
            if w.closed():
                raise ChannelClosed("decode replica closed the KV ring")
            stalls.inc(1.0)
            time.sleep(0.005)
        payload = self._export(prompt, params or SamplingParams())
        with self._writelock:
            w.write(("kv", {"cid": cid, "payload": payload,
                            "params": params}))
        _chan_counter("rtpu_llm_pd_chan_kv_writes_total",
                      "KV payloads sealed into decode rings").inc(1.0)
        return cid

    def has_kv_channel(self) -> bool:
        """Capability probe for serve-path callers: True once the
        controller (or proxy) has paired this replica with a decode
        ring — the signal that prefill_chan() routing can engage."""
        return self._kv_writer is not None

    def close_kv_channel(self) -> None:
        """End the stream: the sentinel retires the decode-side drain
        thread, which sweeps the ring (reader.retire()) and then acks the
        end; this returns on that ack, so the channel holds no store
        object when it does. Raises ``GetTimeoutError`` when no ack
        comes within ``_CLOSE_TIMEOUT_S`` (the decode replica is gone)."""
        w, self._kv_writer = self._kv_writer, None
        if w is None:
            return
        from ..dag.channel import EOS_SEQ, ChannelClosed, await_ack
        try:
            with self._writelock:
                w.write(("e", None))
            await_ack(w.store, w.ack_base, EOS_SEQ, w.stop,
                      _CLOSE_TIMEOUT_S)
        except ChannelClosed:
            pass  # consumer already cancelled: ring swept on its side

    def check_health(self):
        return True


class DecodeReplica:
    """Owns a paged engine that only ever decodes externally-prefilled
    sequences. A background thread steps the engine so imported requests
    decode continuously; callers either block (`decode`) or stream
    (`start` + `poll`, the replica-side half of the proxy's async token
    stream — reference `_predict`'s async generator,
    prefill_decode_disagg.py:98)."""

    def __init__(self, engine_cfg, params=None, rng_seed: int = 0,
                 warmup: bool = True, device="cuda"):
        self.engine, self.device = _build_engine(engine_cfg, params,
                                                 rng_seed, device)
        if warmup:
            # decode-only replica: imported KV pages, no prefill programs
            with _device_scope(self.device):
                self.engine.warmup(families=("decode", "verify"))
        self._reqs: dict[int, Any] = {}
        self._next_rid = 0
        # serializes import_prefill against the stepping thread (the
        # engine's own _lock only guards admission, not the decode step).
        # On the card every import (H2D copy, index_copy_) and every
        # replay is issued on the device's current stream, so the host
        # order this lock sets is the device order too
        self._steplock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._error: Optional[BaseException] = None
        # sealed-channel handoff state: correlation id -> rid for KV
        # payloads that arrived over a ring instead of an actor call
        self._cids: dict[Any, int] = {}
        self._cid_cv = threading.Condition()
        self._chan_threads: list = []
        # ONE result ring per replica (a ring has one sequential
        # producer): every KV drain thread funnels finished decodes
        # through this shared flusher state
        self._res_writer = None
        self._res_pending: list = []
        self._res_cv = threading.Condition()
        self._kv_rings_open = 0
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        try:
            with _device_scope(self.device):
                while not self._stop:
                    with self._steplock:
                        worked = self.engine.has_work()
                        if worked:
                            self.engine.step()
                    if not worked:
                        self._wake.wait(timeout=0.02)
                        self._wake.clear()
        except BaseException as e:  # noqa: BLE001 — engine died: fail fast
            self._error = e
            for req in list(self._reqs.values()):
                req.event.set()

    def start(self, payload, params: Optional[SamplingParams] = None) -> int:
        """Import a prefilled KV payload into the decode pool; returns a
        request id for poll()/wait()."""
        if self._error is not None:
            raise RuntimeError("decode engine died") from self._error
        from ..core.ref import ObjectRef
        if isinstance(payload, ObjectRef):
            # prefill_ref hands out a ref-to-the-payload: the KV bytes
            # cross store-to-store here, on the decode replica, never
            # through the proxy
            import ray_tpu_torch
            payload = ray_tpu_torch.get(payload, timeout=300)
        with _device_scope(self.device), self._steplock:
            req = self.engine.import_prefill(payload,
                                             params or SamplingParams())
        rid = self._next_rid
        self._next_rid += 1
        self._reqs[rid] = req
        self._wake.set()
        return rid

    def poll(self, rid: int) -> dict:
        """Non-blocking progress read: {text, n_tokens, done,
        finish_reason} for a started request. The proxy's streaming
        generator turns successive polls into SSE deltas."""
        if self._error is not None:
            raise RuntimeError("decode engine died") from self._error
        req = self._reqs[rid]
        out = {
            "text": self.engine.tokenizer.decode(list(req.out_ids)),
            "n_tokens": len(req.out_ids),
            "done": req.done,
            "finish_reason": None,
        }
        if req.done:
            res = self.engine._result(req)
            out["text"] = res["text"]
            out["finish_reason"] = res["finish_reason"]
            out["prompt_tokens"] = res["prompt_tokens"]
            self._reqs.pop(rid, None)
        return out

    def wait(self, rid: int, timeout: float = 600.0) -> dict:
        """Block until the request finishes; returns the engine's result
        dict (the non-streaming completion path)."""
        req = self._reqs[rid]
        deadline = time.monotonic() + timeout
        while not req.event.wait(timeout=0.5):
            if self._error is not None:
                raise RuntimeError("decode engine died") from self._error
            if time.monotonic() > deadline:
                raise TimeoutError(f"decode of request {rid} timed out")
        self._reqs.pop(rid, None)
        return self.engine._result(req)

    def decode(self, payload, params: Optional[SamplingParams] = None):
        """Import a prefilled KV payload and decode to completion; returns
        the engine's result dict {text, token_ids, ...}."""
        return self.wait(self.start(payload, params))

    def decode_stream(self, payload,
                      params: Optional[SamplingParams] = None):
        """Generator: import the KV payload and yield progress dicts
        ({text, n_tokens, done, finish_reason}) as tokens land. One
        streaming call carries the whole request, so a serve streaming
        handle stays pinned to THIS replica — no cross-replica
        request-id routing. The request entry is dropped even when the
        consumer abandons the stream mid-way (client disconnect)."""
        rid = self.start(payload, params)
        req = self._reqs[rid]
        sent = 0
        try:
            while True:
                if self._error is not None:
                    raise RuntimeError(
                        "decode engine died") from self._error
                n = len(req.out_ids)
                if req.done:
                    res = self.engine._result(req)
                    yield {"text": res["text"], "n_tokens": n,
                           "done": True,
                           "finish_reason": res["finish_reason"],
                           "prompt_tokens": res["prompt_tokens"]}
                    return
                if n > sent:
                    sent = n
                    yield {"text": self.engine.tokenizer.decode(
                               list(req.out_ids)),
                           "n_tokens": n, "done": False,
                           "finish_reason": None}
                else:
                    time.sleep(0.01)
        finally:
            self._reqs.pop(rid, None)

    # -- sealed-channel KV handoff (consumer side) -------------------------

    def open_kv_channel(self, ring: int = 4,
                        result_chan: Optional[dict] = None) -> dict:
        """Mint a KV-handoff ring this replica consumes and start its
        drain thread; returns the channel spec the paired prefill
        replica connects to (empty dict = no shared store, caller falls
        back to actor-call handoff). Each paired prefill replica gets
        its OWN ring — a ring has exactly one sequential producer.

        ``result_chan`` (optional, same spec shape) makes finished
        decodes flow back the same way: a writer this replica produces
        into, carrying ("res", {cid, result}) — so in steady state a
        request's handoff AND its completion cross no control
        dispatch."""
        import os
        store = _shared_store()
        if store is None:
            return {}
        from ..core.ids import ObjectID
        from ..dag.channel import (EOS_SEQ, ChannelClosed, RingReader,
                                   RingWriter, send_ack)
        spec = {"base": os.urandom(16), "stop": os.urandom(16),
                "ring": max(2, int(ring))}
        reader = RingReader(store, spec["base"], ObjectID(spec["stop"]),
                            spec["ring"])
        want_results = bool(result_chan)
        with self._res_cv:
            self._kv_rings_open += 1
            if want_results and self._res_writer is None:
                self._res_writer = RingWriter(
                    store, result_chan["base"],
                    ObjectID(result_chan["stop"]),
                    int(result_chan["ring"]))
                tf = threading.Thread(target=self._flush_results,
                                      daemon=True,
                                      name="pd-kv-chan-results")
                tf.start()
                self._chan_threads.append(tf)

        def drain():
            try:
                while True:
                    try:
                        kind, item = reader.read(timeout_s=None)
                    except ChannelClosed:
                        reader.retire()
                        break
                    if kind != "kv":            # ("e", None) sentinel
                        reader.retire()
                        # the ring is swept: ack the end, on which the
                        # producer's close_kv_channel returns
                        send_ack(store, reader.ack_base, EOS_SEQ)
                        break
                    rid = self.start(item["payload"], item["params"])
                    _chan_counter(
                        "rtpu_llm_pd_chan_kv_imports_total",
                        "KV payloads imported from sealed rings").inc(1.0)
                    with self._cid_cv:
                        self._cids[item["cid"]] = rid
                        self._cid_cv.notify_all()
                    if want_results:
                        with self._res_cv:
                            self._res_pending.append((item["cid"], rid))
                            self._res_cv.notify_all()
            except BaseException as e:  # noqa: BLE001 — surface via health
                if self._error is None:
                    self._error = e
            finally:
                with self._res_cv:
                    self._kv_rings_open -= 1
                    self._res_cv.notify_all()

        t = threading.Thread(target=drain, daemon=True,
                             name="pd-kv-chan-drain")
        t.start()
        self._chan_threads.append(t)
        return spec

    def _flush_results(self):
        """Seal finished decodes into the replica's ONE result ring
        (completion order within the in-flight window); the EOS
        sentinel trails the last result — after every KV ring closed —
        so the consumer's retire() leaves no store object."""
        from ..dag.channel import ChannelClosed
        live: list = []
        try:
            while True:
                with self._res_cv:
                    if not self._res_pending and not live \
                            and self._kv_rings_open > 0:
                        self._res_cv.wait(timeout=0.5)
                    live.extend(self._res_pending)
                    self._res_pending.clear()
                    rings_open = self._kv_rings_open
                progressed = False
                for cid, rid in list(live):
                    req = self._reqs.get(rid)
                    if req is not None and not req.done:
                        continue
                    live.remove((cid, rid))
                    progressed = True
                    res = self.wait(rid, timeout=600.0)
                    with self._cid_cv:
                        self._cids.pop(cid, None)
                    self._res_writer.write(("res", {"cid": cid,
                                                    "result": res}))
                    _chan_counter(
                        "rtpu_llm_pd_chan_results_total",
                        "decode results sealed into result rings").inc(1.0)
                if rings_open == 0 and not live:
                    with self._res_cv:
                        if not self._res_pending:
                            self._res_writer.write(("e", None))
                            return
                elif live and not progressed:
                    time.sleep(0.005)
        except ChannelClosed:
            pass  # result consumer cancelled: ring swept on its side
        except BaseException as e:  # noqa: BLE001 — surface via health
            if self._error is None:
                self._error = e

    def wait_cid(self, cid, timeout: float = 600.0) -> dict:
        """Block until the request handed off under correlation id
        ``cid`` (prefill_chan) finishes; returns the engine result dict.
        The serve PD path uses this when no result ring is wired: the
        KV handoff itself still crossed no dispatch."""
        deadline = time.monotonic() + timeout
        with self._cid_cv:
            while cid not in self._cids:
                if self._error is not None:
                    raise RuntimeError(
                        "decode engine died") from self._error
                if not self._cid_cv.wait(timeout=min(
                        0.5, max(deadline - time.monotonic(), 0.001))):
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"KV payload for cid {cid!r} never arrived")
            rid = self._cids.pop(cid)
        return self.wait(rid, timeout=max(deadline - time.monotonic(),
                                          0.001))

    def check_health(self):
        if self._error is not None or not self._thread.is_alive():
            raise RuntimeError("decode engine loop died") from self._error
        return True


@dataclasses.dataclass
class _PDStats:
    requests: int = 0
    prefill_rr: int = 0
    decode_rr: int = 0


class PDProxy:
    """Routes generate() calls: prefill on one replica group, decode on the
    other, round-robin (reference PDProxyServer:64 — its router also
    round-robins pow-2 within each group)."""

    def __init__(self, prefill_handles: list, decode_handles: list,
                 use_channels: bool = False):
        if not prefill_handles or not decode_handles:
            raise ValueError("need at least one prefill and one decode "
                             "replica")
        self.prefill = list(prefill_handles)
        self.decode = list(decode_handles)
        self.stats = _PDStats()
        # generate() runs on max_concurrency threads: counters need a lock
        self._lock = threading.Lock()
        self._chan = False
        self._next_cid = 0
        self._futures: dict[int, list] = {}   # cid -> [Event, result]
        if use_channels:
            self._chan = self._wire_channels()

    def _wire_channels(self) -> bool:
        """Sealed-channel pipeline: prefill i produces into a KV ring
        its paired decode replica (i mod n_decode) consumes; every
        decode replica produces finished results into ONE result ring
        this proxy consumes. Steady-state per request: one admission
        call to the prefill replica, then the KV handoff AND the result
        cross no control dispatch. Wiring costs O(replicas) dispatches
        once."""
        import os

        import ray_tpu_torch
        store = _shared_store()
        if store is None:
            return False
        from ..core.ids import ObjectID
        from ..dag.channel import ChannelClosed, RingReader
        self._res_readers = []
        res_spec = {di: {"base": os.urandom(16), "stop": os.urandom(16),
                         "ring": 8} for di in range(len(self.decode))}
        res_handed = []
        kv_specs = {}
        for pi in range(len(self.prefill)):
            di = pi % len(self.decode)
            rs = res_spec.pop(di, None)     # one result ring per decode
            spec = ray_tpu_torch.get(self.decode[di].open_kv_channel.remote(
                4, rs), timeout=60)
            if not spec:
                return False
            if rs is not None:
                res_handed.append(rs)
            kv_specs[pi] = spec
        for pi, p in enumerate(self.prefill):
            if not ray_tpu_torch.get(
                    p.connect_kv_channel.remote(kv_specs[pi]), timeout=60):
                return False

        def drain(spec):
            reader = RingReader(store, spec["base"],
                                ObjectID(spec["stop"]), int(spec["ring"]))
            try:
                while True:
                    try:
                        kind, item = reader.read(timeout_s=None)
                    except ChannelClosed:
                        reader.retire()
                        return
                    if kind != "res":           # ("e", None) sentinel
                        reader.retire()
                        return
                    fut = self._futures.get(item["cid"])
                    if fut is not None:
                        fut[1] = item["result"]
                        fut[0].set()
            except Exception:
                import traceback
                traceback.print_exc()

        for spec in res_handed:
            t = threading.Thread(target=drain, args=(spec,), daemon=True,
                                 name="pd-proxy-results")
            t.start()
            self._res_readers.append(t)
        return True

    def generate(self, prompt, params: Optional[SamplingParams] = None):
        import ray_tpu_torch
        s = self.stats
        with self._lock:
            s.requests += 1
            p = self.prefill[s.prefill_rr % len(self.prefill)]
            d = self.decode[s.decode_rr % len(self.decode)]
            s.prefill_rr += 1
            s.decode_rr += 1
        if self._chan:
            with self._lock:
                cid = self._next_cid
                self._next_cid += 1
                fut = self._futures[cid] = [threading.Event(), None]
            # admission is the ONLY control dispatch: the KV payload
            # rides the sealed ring to the paired decode replica and
            # the result rides the result ring back
            admit = p.prefill_chan.remote(prompt, cid, params)
            if not fut[0].wait(timeout=600):
                raise TimeoutError(f"PD channel request {cid} timed out")
            with self._lock:
                self._futures.pop(cid, None)
            ray_tpu_torch.get(admit, timeout=60)  # reclaim the admission ref
            return fut[1]
        # the payload ObjectRef flows straight into the decode call — the
        # KV bytes move store-to-store, never through this proxy
        payload_ref = p.prefill.remote(prompt, params)
        return ray_tpu_torch.get(d.decode.remote(payload_ref, params),
                                 timeout=600)

    def shutdown_channels(self, timeout: float = 60.0) -> None:
        """Teardown: close every KV ring (sentinel -> decode drains
        retire -> result rings EOS -> proxy drains retire). After this,
        the channels hold no store object."""
        if not self._chan:
            return
        import ray_tpu_torch
        ray_tpu_torch.get([p.close_kv_channel.remote()
                           for p in self.prefill], timeout=timeout)
        for t in self._res_readers:
            t.join(timeout=timeout)
        self._chan = False

    def proxy_stats(self) -> dict:
        with self._lock:
            st = dataclasses.asdict(self.stats)
        st["channels"] = self._chan
        return st


def _params_from_request(request: dict) -> SamplingParams:
    return SamplingParams(
        max_tokens=int(request.get("max_tokens", 64)),
        temperature=float(request.get("temperature", 0.0)),
        top_k=int(request.get("top_k", 0)),
    )


class PDServer:
    """Disaggregated drop-in for LLMServer behind the OpenAI ingress
    (reference: PDProxyServer subclasses the LLM server,
    prefill_decode_disagg.py:64, streaming `_predict` :98): speaks the
    same completions/completions_stream surface, but each request
    prefills on one replica group and decodes on the other. The KV
    payload crosses over the paired ring channel, or as an ObjectRef —
    store-to-store on the data plane, never through this proxy."""

    def __init__(self, model_id: str, prefill_handle, decode_handle,
                 use_channels: bool = False):
        from ..core.usage import record_library_usage
        record_library_usage("llm")
        self.model_id = model_id
        self.prefill = prefill_handle
        self.decode = decode_handle
        self._chan = bool(use_channels)
        self._chan_ok: Optional[bool] = None  # lazy capability probe
        self._n_pre = 0
        self._n_dec = 0
        self._rr = 0
        self._rr_lock = threading.Lock()

    def _chan_ready(self) -> bool:
        """Probe (once) whether the sealed-channel handoff is wired:
        the controller pairs role=prefill replicas to decode KV rings
        asynchronously after deploy, so the first request that finds
        the pairing incomplete settles the server onto the ref-based
        path for good — routing stays deterministic per process."""
        if not self._chan:
            return False
        if self._chan_ok is None:
            try:
                self._n_pre = self.prefill.num_replicas()
                self._n_dec = self.decode.num_replicas()
                ok = self.prefill.options(
                    method_name="has_kv_channel",
                    replica_index=0).remote().result(timeout_s=30)
                self._chan_ok = bool(ok) and \
                    self._n_pre > 0 and self._n_dec > 0
            except Exception:
                self._chan_ok = False
        return self._chan_ok

    def _response(self, out: dict) -> dict:
        return {
            "object": "text_completion",
            "model": self.model_id,
            "choices": [{
                "text": out["text"],
                "finish_reason": out["finish_reason"],
                "index": 0,
            }],
            "usage": {
                "prompt_tokens": out["prompt_tokens"],
                "completion_tokens": len(out["token_ids"]),
            },
        }

    def _chan_completion(self, request: dict) -> dict:
        """Channel-path unary completion: prefill_chan seals the KV
        payload straight into the paired decode replica's ring (no
        handoff dispatch — the two control calls here are admission
        and result collection, same count as the ref path, but the KV
        bytes never surface as an ObjectRef). Replica indices follow
        the controller's pairing rule (prefill i -> decode i % n_dec),
        so the wait lands on the replica that imports the payload."""
        import os
        sp = _params_from_request(request)
        with self._rr_lock:
            i_pre = self._rr % self._n_pre
            self._rr += 1
        i_dec = i_pre % self._n_dec
        cid = os.urandom(8).hex()
        admit = self.prefill.options(
            method_name="prefill_chan", replica_index=i_pre).remote(
                request.get("prompt", ""), cid, sp)
        admit.result(timeout_s=300)  # surfaces prefill/ring errors
        out = self.decode.options(
            method_name="wait_cid", replica_index=i_dec).remote(
                cid).result(timeout_s=600)
        return self._response(out)

    def _prefill_ref(self, request: dict):
        """Run prefill on one replica; returns (payload ObjectRef,
        SamplingParams). The decode side receives only the ref — KV bytes
        move store-to-store."""
        sp = _params_from_request(request)
        return self.prefill.options(
            method_name="prefill_ref").remote(
                request.get("prompt", ""), sp).result(timeout_s=300), sp

    def completions(self, request: dict) -> dict:
        if self._chan_ready():
            return self._chan_completion(request or {})
        # one unary call per request: the serve handle picks a decode
        # replica once and the whole decode happens there (no
        # cross-replica request-id routing to get wrong)
        payload_ref, sp = self._prefill_ref(request or {})
        out = self.decode.options(method_name="decode").remote(
            payload_ref, sp).result(timeout_s=600)
        return self._response(out)

    def completions_stream(self, request: dict):
        """Generator of token-delta chunks: ONE streaming call to a decode
        replica (the generator stays replica-pinned) re-emitted as OpenAI
        chunks (the role of the reference's router StreamingResponse over
        `_predict`, router.py:259-264)."""
        payload_ref, sp = self._prefill_ref(request or {})
        gen = self.decode.options(method_name="decode_stream",
                                  stream=True).remote(payload_ref, sp)
        emitted = ""
        for out in gen:
            text = out["text"]
            if out["done"]:
                # on prefix divergence (multi-byte fallback spanning more
                # than the withheld window) emit from the boundary anyway:
                # a few garbled chars beat re-sending the whole completion
                tail = text[len(emitted):]
                yield {"object": "text_completion.chunk",
                       "model": self.model_id,
                       "choices": [{"text": tail, "index": 0,
                                    "finish_reason": out["finish_reason"]}]}
                # read the replica's stream to its end: the end retires
                # its ring channel, which a stream left unread keeps in
                # the store (its trailing acks and end marker)
                for _ in gen:
                    pass
                return
            # withhold the last few chars: a partial multi-byte token
            # sequence decodes to replacement chars that the next token
            # may rewrite — emit only the stable prefix
            stable = text[:max(0, len(text) - 4)]
            if stable.startswith(emitted) and len(stable) > len(emitted):
                delta = stable[len(emitted):]
                emitted = stable
                yield {"object": "text_completion.chunk",
                       "model": self.model_id,
                       "choices": [{"text": delta, "index": 0,
                                    "finish_reason": None}]}

    def __call__(self, request: dict) -> dict:
        return self.completions(request or {})

    def check_health(self):
        return True


def _role_options(gpus_per_replica) -> dict:
    from .serving import whole_gpus
    n = whole_gpus(gpus_per_replica)
    return {"num_gpus": n} if n else {}


def build_pd_openai_app(model_id: str, n_prefill: int, n_decode: int,
                        engine_cfg, params=None, rng_seed: int = 0,
                        use_channels: bool = False, device="cuda",
                        gpus_per_replica: int = 1):
    """Disaggregated OpenAI app (reference build_app,
    prefill_decode_disagg.py:160): prefill and decode replica groups as
    Serve deployments, a PDServer deployment routing between them, and
    the OpenAI router as ingress — /v1/completions with stream=true
    crosses the prefill->decode handoff and streams SSE out the HTTP
    proxy. The role tags let the controller pair each prefill replica
    with a decode KV ring; with ``use_channels`` the PDServer routes
    unary completions over that sealed handoff once pairing lands. Each
    replica of both groups asks for ``gpus_per_replica`` whole GPUs and
    builds its engine on ``device``."""
    from .. import serve
    from .openai_api import OpenAIRouter
    opts = _role_options(gpus_per_replica)
    pre = serve.deployment(
        PrefillReplica, name=f"pd-prefill:{model_id}",
        num_replicas=n_prefill, ray_actor_options=opts,
        role="prefill").bind(engine_cfg, params, rng_seed, device=device)
    dec = serve.deployment(
        DecodeReplica, name=f"pd-decode:{model_id}",
        num_replicas=n_decode, ray_actor_options=opts,
        role="decode").bind(engine_cfg, params, rng_seed, device=device)
    pd = serve.deployment(
        PDServer, name=f"pd:{model_id}").bind(
            model_id, pre, dec, use_channels)
    router = serve.deployment(OpenAIRouter, name="openai-router")
    return router.bind([model_id], pd)


def build_pd_proxy(n_prefill: int, n_decode: int, engine_cfg,
                   params=None, rng_seed: int = 0,
                   prefill_options: Optional[dict] = None,
                   decode_options: Optional[dict] = None,
                   use_channels: bool = False, device="cuda",
                   gpus_per_replica: int = 1):
    """Actor-graph wiring (reference build_app:160): N prefill + M decode
    replica actors behind one PDProxy actor. Returns the proxy handle.
    With ``use_channels`` the proxy wires the sealed-ring KV handoff at
    construction (falls back to actor-call handoff when no shared store
    is available). Each replica actor asks for ``gpus_per_replica`` whole
    GPUs."""
    import ray_tpu_torch
    role = _role_options(gpus_per_replica)
    popts, dopts = prefill_options or {}, decode_options or {}
    Pre = ray_tpu_torch.remote(PrefillReplica)
    Dec = ray_tpu_torch.remote(DecodeReplica)
    prefills = [Pre.options(**popts, **role).remote(
        engine_cfg, params, rng_seed, device=device)
        for _ in range(n_prefill)]
    decodes = [Dec.options(**dopts, **role).remote(
        engine_cfg, params, rng_seed, device=device)
        for _ in range(n_decode)]
    Proxy = ray_tpu_torch.remote(PDProxy)
    return Proxy.options(max_concurrency=16).remote(
        prefills, decodes, use_channels)
