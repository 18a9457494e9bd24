"""RemoteVerifier: WebSocket server hosting wake-word inference remotely.

Parity target: `/root/reference/nanowakeword/interpreter/remote_verifier.py` —
`serve()` (`:160`), the per-connection streaming state (`:269-363`), the
client-side `_RemoteSession` drop-in session (`:463-635`), and the module
CLI (`:640-755`), with the same wire protocol:

    0x01 features  header <Biii> (tag, batch, time, feat) + float32 body
    0x02 mel       header <Biii> (tag, batch, frames, mel_bins) + float32 body
    0x03 audio     header <Bi>   (tag, n_samples) + int16 body
    0xF0 token exchange (server_security)
    response: JSON {"score": <float>}

Differences from the reference:
* the hosted model is a `.nww` artifact evaluated by a jitted Flax apply —
  scores for many concurrent clients batch onto the accelerator naturally;
* "full"-pipeline connections use our jit-compiled AudioFeatures streaming
  state, which is exactly equal to the batch pipeline;
* the 0x02 "embedding" mode — declared but left unhandled in the reference
  (`remote_verifier.py:97-99` vs. `:404-428`) — is actually served here.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import struct
from typing import Optional, Union

import numpy as np

from nanowakeword_tpu.interpreter.server_security import (
    SecurityConfig, SecurityManager, build_security, decode_token_request,
    encode_error_response, encode_token_response, is_token_request, client_ip)

logger = logging.getLogger(__name__)

PIPELINE_VERIFIER_ONLY = "verifier_only"
PIPELINE_EMBEDDING = "embedding"
PIPELINE_FULL = "full"
_VALID_PIPELINES = {PIPELINE_VERIFIER_ONLY, PIPELINE_EMBEDDING, PIPELINE_FULL}

_TAG_FEATURES = 0x01
_TAG_MEL = 0x02
_TAG_AUDIO = 0x03


# -- wire helpers (shared with _RemoteSession) ----------------------------------

def encode_features(features: np.ndarray) -> bytes:
    b, t, f = features.shape
    return (struct.pack("<Biii", _TAG_FEATURES, b, t, f)
            + features.astype(np.float32).tobytes())


def encode_mel(mel: np.ndarray) -> bytes:
    b, t, f = mel.shape
    return (struct.pack("<Biii", _TAG_MEL, b, t, f)
            + mel.astype(np.float32).tobytes())


def encode_audio(audio: np.ndarray) -> bytes:
    return (struct.pack("<Bi", _TAG_AUDIO, len(audio))
            + audio.astype(np.int16).tobytes())


def decode_score(response: Union[str, bytes]) -> float:
    return float(json.loads(response).get("score", 0.0))


# -- dynamic micro-batching -----------------------------------------------------

class _DynamicBatcher:
    """Cross-client micro-batching onto the accelerator.

    New capability vs. the reference (which scores each client's message in
    its own ONNX call): concurrent score requests arriving within
    `max_wait_ms` coalesce into ONE batched device forward — under load the
    device sees large batches instead of B=1 calls. A classic production
    inference-server pattern (dynamic batching).
    """

    def __init__(self, session, max_batch: int = 256,
                 max_wait_ms: float = 4.0, pad_to_pow2: bool = True):
        import asyncio
        self.session = session
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self.pad_to_pow2 = pad_to_pow2
        self._queue: "asyncio.Queue" = asyncio.Queue()
        self._task = None

    def start(self):
        # called from within the server's running loop (asyncio.start_server
        # context); get_running_loop is the non-deprecated accessor
        import asyncio
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(self._run())

    async def score(self, features: np.ndarray) -> float:
        import asyncio
        fut = asyncio.get_running_loop().create_future()
        await self._queue.put((features, fut))
        return await fut

    async def _run(self):
        import asyncio
        loop = asyncio.get_running_loop()
        while True:
            first = await self._queue.get()
            batch = [first]
            deadline = loop.time() + self.max_wait
            while len(batch) < self.max_batch:
                timeout = deadline - loop.time()
                if timeout <= 0:
                    break
                try:
                    batch.append(await asyncio.wait_for(self._queue.get(),
                                                        timeout))
                except asyncio.TimeoutError:
                    break
            feats = np.concatenate([b[0] for b in batch], axis=0)
            n = feats.shape[0]
            if self.pad_to_pow2 and n > 1:
                # bucket batch sizes to powers of two: bounded recompiles
                padded = 1 << (n - 1).bit_length()
                if padded != n:
                    feats = np.concatenate(
                        [feats, np.zeros((padded - n,) + feats.shape[1:],
                                         feats.dtype)], axis=0)
            try:
                probs = await loop.run_in_executor(
                    None, self.session.run_batch, feats)
                for (_, fut), p in zip(batch, probs[:n]):
                    if not fut.done():
                        fut.set_result(float(p))
            except Exception as e:  # noqa: BLE001
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)


# -- server ------------------------------------------------------------------------

def serve(model_path: str,
          pipeline: str = PIPELINE_VERIFIER_ONLY,
          host: str = "0.0.0.0",
          port: int = 8765,
          log_level: str = "INFO",
          security: Optional[Union[SecurityConfig, SecurityManager]] = None,
          batching: bool = True,
          max_batch: int = 256,
          batch_wait_ms: float = 4.0,
          data_parallel: int = 0,
          _ready_callback=None) -> None:
    """Start the RemoteVerifier WebSocket server; blocks until interrupted.

    data_parallel: shard batched scoring over a device mesh — 0 disables,
    -1 uses every visible device, N uses the first N. Composes with dynamic
    micro-batching: coalesced request batches split across chips (new
    capability; the reference is single-host single-session).
    """
    if pipeline not in _VALID_PIPELINES:
        raise ValueError(f"Invalid pipeline '{pipeline}'. "
                         f"Choose from: {sorted(_VALID_PIPELINES)}")

    security_manager: Optional[SecurityManager] = None
    if security is not None:
        if isinstance(security, SecurityConfig):
            security_manager = SecurityManager(security)
        elif isinstance(security, SecurityManager):
            security_manager = security
        else:
            raise TypeError("security must be a SecurityConfig or "
                            "SecurityManager instance")

    try:
        import asyncio
        import websockets
    except ImportError:
        raise ImportError("websockets is required for RemoteVerifier. "
                          "Install it with: pip install websockets")

    logging.basicConfig(
        level=getattr(logging, log_level.upper(), logging.INFO),
        format="%(asctime)s [%(levelname)s] %(message)s", datefmt="%H:%M:%S")

    from nanowakeword_tpu.export.artifact import load_nww
    from nanowakeword_tpu.interpreter.nanointerpreter import (_LocalSession,
                                                              _OnnxSession)
    from nanowakeword_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    mesh = None
    if data_parallel:
        import jax
        from nanowakeword_tpu.parallel.mesh import make_mesh
        n_dev = (len(jax.devices()) if data_parallel < 0
                 else min(data_parallel, len(jax.devices())))
        if n_dev > 1:
            mesh = make_mesh(n_dev)
            logger.info(f"Data-parallel serving over {n_dev} devices")
        else:
            logger.info("data_parallel requested but only one device "
                        "visible; serving single-device")
    if model_path.endswith(".onnx"):
        # the reference serves exported .onnx models (remote_verifier.py:
        # 223-230); here the graph jit-compiles onto the serving backend
        ww_session = _OnnxSession(model_path)
        encoder_vars = None
        model_name = os.path.splitext(os.path.basename(model_path))[0]
        if mesh is not None:
            logger.info(".onnx serving is single-device; ignoring "
                        "--data-parallel (use the .nww artifact to shard)")
    else:
        header, model, encoder_vars = load_nww(model_path)
        ww_session = _LocalSession(model, header, mesh=mesh)
        model_name = header.get("model_name", "model")
    n_frames = ww_session.feature_length
    batcher = (_DynamicBatcher(ww_session, max_batch=max_batch,
                               max_wait_ms=batch_wait_ms)
               if batching and not ww_session.stateful else None)
    logger.info(f"Wake word model: '{model_name}'  "
                f"input=[batch, {n_frames}, 96]")
    logger.info(f"Pipeline mode:   '{pipeline}'")
    if security_manager is not None:
        logger.info(f"Security:        {security_manager.config.summary()}")

    frontend = None
    if pipeline in (PIPELINE_EMBEDDING, PIPELINE_FULL):
        from nanowakeword_tpu.data.features import AudioFeatures
        # One shared frontend for batch ops; per-connection streaming states
        # are cheap jit-state pytrees created from it.
        frontend = AudioFeatures(encoder_variables=encoder_vars)
        logger.info("Mel + embedding frontend compiled on server.")

    class _Connection:
        """Per-client streaming pipeline state (full mode)."""

        def __init__(self):
            from nanowakeword_tpu.data.features import AudioFeatures
            self.features = AudioFeatures(
                encoder_variables=frontend.encoder_variables)

        def process(self, audio: np.ndarray) -> Optional[np.ndarray]:
            processed = self.features(audio)
            if processed < 1280:
                return None
            if self.features.feature_buffer.shape[0] < n_frames:
                return None
            return self.features.get_features(n_frames)

    async def handle_client(websocket):
        addr = websocket.remote_address
        ip = client_ip(websocket)
        logger.info(f"Client connected: {addr}  pipeline='{pipeline}'")
        state = _Connection() if pipeline == PIPELINE_FULL else None
        connected = False
        try:
            if security_manager is not None:
                allowed, reason = security_manager.check_handshake(websocket)
                if not allowed:
                    logger.warning(f"Rejected connection from {ip}: {reason}")
                    await websocket.close(code=1008, reason=reason)
                    return
                security_manager.on_connect()
                connected = True

            async for message in websocket:
                if not isinstance(message, bytes) or len(message) < 1:
                    continue
                if (security_manager is not None
                        and not security_manager.record_request(ip)):
                    await websocket.close(code=1008,
                                          reason="rate limit exceeded")
                    return
                if (security_manager is not None
                        and security_manager.config.enable_tokens
                        and is_token_request(message)):
                    api_key = decode_token_request(message)
                    if security_manager.verify_api_key(api_key):
                        await websocket.send(encode_token_response(
                            security_manager.issue_token()))
                    else:
                        await websocket.send(
                            encode_error_response("invalid API key"))
                        await websocket.close(code=1008,
                                              reason="invalid API key")
                    continue

                tag = message[0]
                score = 0.0

                if tag == _TAG_FEATURES:
                    b, t, f = struct.unpack("<iii", message[1:13])
                    feats = np.frombuffer(
                        message[13:13 + b * t * f * 4],
                        dtype=np.float32).reshape(b, t, f)
                    if batcher is not None and b == 1:
                        score = await batcher.score(feats)
                    else:
                        score, _ = ww_session.run(feats)

                elif tag == _TAG_MEL and pipeline in (PIPELINE_EMBEDDING,
                                                      PIPELINE_FULL):
                    b, t, f = struct.unpack("<iii", message[1:13])
                    mel = np.frombuffer(
                        message[13:13 + b * t * f * 4],
                        dtype=np.float32).reshape(b, t, f)
                    import jax.numpy as jnp
                    emb = np.asarray(frontend.encoder.apply(
                        frontend.encoder_variables, jnp.asarray(mel)))
                    if emb.shape[1] >= n_frames:
                        window = emb[:, -n_frames:]
                        if batcher is not None and window.shape[0] == 1:
                            score = await batcher.score(window)
                        else:
                            score, _ = ww_session.run(window)

                elif tag == _TAG_AUDIO and pipeline == PIPELINE_FULL:
                    (n_samples,) = struct.unpack("<i", message[1:5])
                    audio = np.frombuffer(message[5:5 + n_samples * 2],
                                          dtype=np.int16)
                    feats = state.process(audio)
                    if feats is not None:
                        if batcher is not None:
                            score = await batcher.score(feats)
                        else:
                            score, _ = ww_session.run(feats)

                await websocket.send(json.dumps({"score": score}))

        except Exception as e:  # noqa: BLE001
            logger.warning(f"Client {addr} error: {e}")
        finally:
            if connected and security_manager is not None:
                security_manager.on_disconnect()
            logger.info(f"Client disconnected: {addr}")

    import asyncio

    async def _main():
        if batcher is not None:
            batcher.start()
            logger.info(f"Dynamic batching: max_batch={max_batch}, "
                        f"window={batch_wait_ms}ms")
        async with websockets.serve(
                handle_client, host, port,
                ssl=security_manager.ssl_context if security_manager
                else None) as server:
            logger.info(f"RemoteVerifier ready on ws://{host}:{port}")
            if _ready_callback is not None:
                _ready_callback(server)
            await asyncio.Future()

    try:
        asyncio.run(_main())
    except KeyboardInterrupt:
        logger.info("RemoteVerifier stopped.")


# -- client-side session --------------------------------------------------------------

class _RemoteSession:
    """Drop-in for a local model session that forwards over WebSocket.

    NanoInterpreter calls `.run(features)` (or `.run_audio(audio)` in full
    mode); this class encodes to the wire protocol, awaits the JSON score,
    auto-reconnects on failure, and returns 0.0 on timeout — matching the
    reference `_RemoteSession` (`remote_verifier.py:463-635`).
    """

    def __init__(self, uri: str, model_name: str,
                 pipeline: str = PIPELINE_VERIFIER_ONLY,
                 n_frames: int = 16, timeout: float = 2.0,
                 api_key: Optional[str] = None,
                 token: Optional[str] = None,
                 ssl_certfile: Optional[str] = None,
                 ssl_keyfile: Optional[str] = None,
                 ssl_ca_certs: Optional[str] = None):
        try:
            import websockets  # noqa: F401
        except ImportError:
            raise ImportError("websockets is required for remote_verifier. "
                              "Install it with: pip install websockets")
        if pipeline not in _VALID_PIPELINES:
            raise ValueError(f"Invalid pipeline '{pipeline}'.")

        import asyncio
        import threading

        self.uri = uri
        self.model_name = model_name
        self.pipeline = pipeline
        self.n_frames = n_frames
        self.timeout = timeout
        self.api_key = api_key
        self.token = token
        self.ssl_certfile = ssl_certfile
        self.ssl_keyfile = ssl_keyfile
        self.ssl_ca_certs = ssl_ca_certs
        self.stateful = False
        self._loop = asyncio.new_event_loop()
        self._ws = None
        self._lock = threading.Lock()
        self._connect()
        logger.info(f"[nanowakeword-tpu] Connected to {uri} "
                    f"pipeline='{pipeline}'")

    @property
    def feature_length(self) -> int:
        return self.n_frames

    def _connect(self):
        import ssl as ssl_mod
        import websockets

        async def _do():
            headers = None
            if self.token:
                headers = {"X-Token": self.token}
            elif self.api_key:
                headers = {"X-API-Key": self.api_key}
            ssl_ctx = None
            if (self.uri.lower().startswith("wss://") or self.ssl_certfile
                    or self.ssl_keyfile or self.ssl_ca_certs):
                ssl_ctx = ssl_mod.create_default_context(
                    ssl_mod.Purpose.SERVER_AUTH)
                if self.ssl_ca_certs:
                    ssl_ctx.load_verify_locations(cafile=self.ssl_ca_certs)
                if self.ssl_certfile:
                    ssl_ctx.load_cert_chain(certfile=self.ssl_certfile,
                                            keyfile=self.ssl_keyfile)
            return await websockets.connect(self.uri, ssl=ssl_ctx,
                                            additional_headers=headers)

        self._ws = self._loop.run_until_complete(_do())

    def _reconnect(self):
        try:
            self._connect()
            logger.info(f"[nanowakeword-tpu] Reconnected to {self.uri}")
        except Exception as e:  # noqa: BLE001
            logger.warning(f"[nanowakeword-tpu] Reconnect failed: {e}")
            self._ws = None

    def _exchange(self, message: bytes) -> float:
        import asyncio

        async def _send_recv():
            try:
                await self._ws.send(message)
                response = await asyncio.wait_for(self._ws.recv(),
                                                  timeout=self.timeout)
                return decode_score(response)
            except Exception as e:  # noqa: BLE001
                logger.warning(f"[nanowakeword-tpu] Communication error: {e}")
                return None

        with self._lock:
            if self._ws is None:
                self._reconnect()
            if self._ws is None:
                return 0.0
            score = self._loop.run_until_complete(_send_recv())
            if score is None:
                self._reconnect()
                return 0.0
            return score

    def _feed_score(self, feed: dict) -> float:
        """Score one ORT-style input_feed dict ({"input": feats} or
        {"audio": int16} — the reference's two remote payload kinds)."""
        if "audio" in feed:
            return self._exchange(encode_audio(np.asarray(feed["audio"])))
        arr = np.asarray(next(iter(feed.values())), np.float32)
        if arr.ndim == 2:
            arr = arr[None]
        return self._exchange(encode_features(arr))

    # NanoInterpreter session interface + reference/ORT parity
    def run(self, features, carry=None, run_options=None):
        """Two call conventions:

        * internal session interface (NanoInterpreter):
              run(features[, carry]) -> (score, carry)
        * onnxruntime ``InferenceSession`` parity, matching the reference
          `_RemoteSession.run` (`remote_verifier.py:576-618`):
              run(output_names, {"input": feats}) -> [np.array([[[score]]])]
          (also accepts run({"audio": x}) / run({"input": feats}) directly)
        """
        if features is None and isinstance(carry, dict):
            return [np.asarray([[[self._feed_score(carry)]]], np.float32)]
        if isinstance(features, dict):
            return [np.asarray([[[self._feed_score(features)]]], np.float32)]
        features = np.asarray(features, np.float32)
        if features.ndim == 2:
            features = features[None]
        return self._exchange(encode_features(features)), None

    def get_inputs(self):
        """ORT-session parity (reference `remote_verifier.py:568-574`)."""
        class _FakeInput:
            def __init__(self, name, shape):
                self.name = name
                self.shape = shape
        return [_FakeInput("input", ["batch_size", self.n_frames, 96])]

    def run_audio(self, audio: np.ndarray) -> float:
        return self._exchange(encode_audio(np.asarray(audio)))

    def request_token(self, api_key: str) -> Optional[str]:
        """Exchange an API key for a short-lived token (tag 0xF0)."""
        from nanowakeword_tpu.interpreter.server_security import \
            encode_token_request
        import asyncio

        async def _send_recv():
            await self._ws.send(encode_token_request(api_key))
            response = await asyncio.wait_for(self._ws.recv(),
                                              timeout=self.timeout)
            return json.loads(response).get("token")

        with self._lock:
            if self._ws is None:
                return None
            try:
                return self._loop.run_until_complete(_send_recv())
            except Exception:  # noqa: BLE001
                return None

    def close(self):
        if self._ws is not None:
            coro = self._ws.close()
            try:
                self._loop.run_until_complete(coro)
            except Exception:  # noqa: BLE001
                coro.close()
            self._ws = None
        try:
            self._loop.close()
        except Exception:  # noqa: BLE001
            pass

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass


# -- CLI ---------------------------------------------------------------------------------

def main(argv=None):
    parser = argparse.ArgumentParser(
        description="nanowakeword-tpu RemoteVerifier - WebSocket inference "
                    "server",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--model", required=True,
                        help="Path to the wake word .nww model artifact")
    parser.add_argument("--pipeline", default=PIPELINE_VERIFIER_ONLY,
                        choices=sorted(_VALID_PIPELINES))
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", default=8765, type=int)
    parser.add_argument("--log", default="INFO")
    parser.add_argument("--api-key", dest="api_keys", action="append",
                        default=[])
    parser.add_argument("--enable-tokens", action="store_true")
    parser.add_argument("--token-ttl", type=int, default=3600)
    parser.add_argument("--token-secret", default=None)
    parser.add_argument("--rate-limit", type=int, default=0)
    parser.add_argument("--rate-window", type=int, default=60)
    parser.add_argument("--ip-allowlist", action="append", default=[])
    parser.add_argument("--ssl-certfile", default=None)
    parser.add_argument("--ssl-keyfile", default=None)
    parser.add_argument("--ssl-ca-certs", default=None)
    parser.add_argument("--max-connections", type=int, default=0)
    parser.add_argument("--ban-duration", type=int, default=300)
    parser.add_argument("--no-batching", action="store_true",
                        help="Disable cross-client dynamic micro-batching.")
    parser.add_argument("--max-batch", type=int, default=256)
    parser.add_argument("--batch-wait-ms", type=float, default=4.0)
    parser.add_argument("--data-parallel", type=int, default=0,
                        help="Shard batched scoring over N devices "
                             "(-1 = all visible devices, 0 = off).")
    args = parser.parse_args(argv)

    security = build_security(
        api_keys=args.api_keys, enable_tokens=args.enable_tokens,
        token_ttl=args.token_ttl, token_secret=args.token_secret,
        rate_limit=args.rate_limit, rate_window=args.rate_window,
        ip_allowlist=args.ip_allowlist, ssl_certfile=args.ssl_certfile,
        ssl_keyfile=args.ssl_keyfile, ssl_ca_certs=args.ssl_ca_certs,
        max_connections=args.max_connections, ban_duration=args.ban_duration)

    serve(model_path=args.model, pipeline=args.pipeline, host=args.host,
          port=args.port, log_level=args.log, security=security,
          batching=not args.no_batching, max_batch=args.max_batch,
          batch_wait_ms=args.batch_wait_ms,
          data_parallel=args.data_parallel)


if __name__ == "__main__":
    main()
