"""aprilslam-torch-serve: a persistent SLAM service (port of
``aprilslam_tpu/apps/serve.py``).

One resident process owns the device, warms the SLAM step once for the shape
declared at startup, keeps the map state across requests, and answers frame
chunks over TCP with per-frame poses. The wire protocol and the response
keys are the JAX service's, byte for byte, so either package's client talks
to either server.

Protocol (length-prefixed, big-endian uint64 sizes):

  request :=  u64 header_len | header JSON | u64 payload_len | payload
  header  :=  {"cmd": "process"}                 payload = raw frame bytes
              {"cmd": "reset" | "stats" | "ping"}   payload empty
  response := u64 body_len | body JSON

Frames are uint8, shape (batch, res, res) grayscale or (batch, res, res, 3)
BGR — exactly the shape the server was started with. The response carries
poses (anchor-tag frame), validity, the coordinate tag id, and map size.
Each response's fields reach the host with one ``.cpu()`` each.

A Python client (`SlamClient`) is included for tests and tooling.

    python -m aprilslam_tpu_torch.apps.serve --port 7444          # on the card
    python -m aprilslam_tpu_torch.apps.serve --device cpu --resolution 256
"""

from __future__ import annotations

import argparse
import json
import socket
import socketserver
import struct
import sys
import threading
import time


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectionError("peer closed mid-message")
        buf.extend(chunk)
    return bytes(buf)


def _send_msg(sock: socket.socket, body: bytes) -> None:
    sock.sendall(struct.pack(">Q", len(body)) + body)


def _recv_msg(sock: socket.socket, max_len: int = 1 << 31) -> bytes:
    (n,) = struct.unpack(">Q", _recv_exact(sock, 8))
    if n > max_len:
        raise ValueError(f"message too large: {n} > {max_len}")
    return _recv_exact(sock, n)


class SlamClient:
    """Blocking client for the service (tests/tooling)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 7444,
                 timeout: float = 120.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)

    def _call(self, header: dict, payload: bytes = b"") -> dict:
        _send_msg(self.sock, json.dumps(header).encode())
        _send_msg(self.sock, payload)
        return json.loads(_recv_msg(self.sock))

    def ping(self) -> dict:
        return self._call({"cmd": "ping"})

    def reset(self) -> dict:
        return self._call({"cmd": "reset"})

    def stats(self) -> dict:
        return self._call({"cmd": "stats"})

    def process(self, frames) -> dict:
        import numpy as np

        arr = np.ascontiguousarray(frames, dtype=np.uint8)
        return self._call({"cmd": "process", "shape": list(arr.shape)},
                          arr.tobytes())

    def close(self) -> None:
        self.sock.close()


def make_server(host, port, camera, family, tag_size, batch, res, channels,
                estimator="ba", detector_params=None, ba_schedule="chunk", device=None):
    """Build the server with the SLAM step warmed for the declared shape on
    ``device`` (``None``: the CUDA device). Returns a
    socketserver.ThreadingTCPServer; requests serialize on a lock (one
    device, one map).

    The warm-up step, reported as ``compile_s`` as in the JAX service, is
    on the card the CCL kernel's build (or load) and the first step."""
    import numpy as np

    from ..slam import SlamSystem

    slam = SlamSystem(
        camera, family, tag_size, estimator=estimator,
        detector_params=detector_params, ba_schedule=ba_schedule, device=device,
    )
    shape = (batch, res, res) + ((channels,) if channels > 1 else ())
    # Warm up so the first client request doesn't pay the build.
    t0 = time.perf_counter()
    slam.process(np.zeros(shape, np.uint8))
    slam.reset()
    compile_s = time.perf_counter() - t0

    lock = threading.Lock()
    stats = {"requests": 0, "frames": 0, "busy_s": 0.0,
             "compile_s": round(compile_s, 1)}

    import math

    payload_cap = max(1 << 20, 4 * math.prod(shape))

    class Handler(socketserver.BaseRequestHandler):
        def handle(self):
            try:
                while True:
                    try:
                        # Headers are small JSON; a huge length prefix is a
                        # protocol violation — answer, then drop the
                        # connection (the stream can't be resynchronized).
                        raw = _recv_msg(self.request, max_len=1 << 20)
                    except ConnectionError:
                        return
                    except ValueError as e:
                        self._reply({"ok": False, "error": str(e)})
                        return
                    try:
                        payload = _recv_msg(self.request, max_len=payload_cap)
                    except ValueError as e:
                        self._reply({"ok": False, "error": str(e)})
                        return
                    # Any per-request failure (malformed JSON, bad shape,
                    # wrong payload size, ...) becomes an error RESPONSE —
                    # never a silently dead handler that leaves the client
                    # blocking on its timeout.
                    try:
                        header = json.loads(raw)
                        if not isinstance(header, dict):
                            raise ValueError("header must be a JSON object")
                        resp = self._dispatch(header, payload)
                    except Exception as e:  # noqa: BLE001 — reply, keep serving
                        resp = {"ok": False,
                                "error": f"{type(e).__name__}: {e}"}
                    self._reply(resp)
            except (ConnectionError, OSError):
                return

        def _reply(self, resp: dict) -> None:
            _send_msg(self.request, json.dumps(resp).encode())

        def _dispatch(self, header, payload):
            cmd = header.get("cmd")
            if cmd == "ping":
                return {"ok": True, "shape": list(shape)}
            if cmd == "reset":
                with lock:
                    slam.reset()
                return {"ok": True}
            if cmd == "stats":
                with lock:
                    out = dict(stats)
                out["fps_busy"] = round(out["frames"] / out["busy_s"], 2) \
                    if out["busy_s"] else None
                return {"ok": True, **out}
            if cmd != "process":
                return {"ok": False, "error": f"unknown cmd {cmd!r}"}
            raw_shape = header.get("shape", ())
            if not (isinstance(raw_shape, (list, tuple))
                    and all(isinstance(v, int) for v in raw_shape)):
                return {"ok": False,
                        "error": f"shape must be a list of ints, got {raw_shape!r}"}
            got = tuple(raw_shape)
            if got != shape:
                return {"ok": False,
                        "error": f"shape {got} != server shape {shape}"}
            if len(payload) != math.prod(shape):
                return {"ok": False,
                        "error": (f"payload {len(payload)} bytes != "
                                  f"{math.prod(shape)} for shape {shape}")}
            import numpy as np

            # A writable copy: torch warns when it wraps a read-only buffer.
            frames = np.frombuffer(bytearray(payload), np.uint8).reshape(shape)
            t0 = time.perf_counter()
            with lock:
                outs = slam.process(frames)
                poses = outs.poses.cpu().numpy()
                valid = outs.valid.cpu().numpy()
                coord = outs.coord_id.cpu().numpy()
                nn = outs.n_nodes.cpu().numpy()
                obs = outs.pose_obs.cpu().numpy()
                dt = time.perf_counter() - t0
                stats["requests"] += 1
                stats["frames"] += batch
                stats["busy_s"] += dt
            return {
                "ok": True,
                "poses": poses.tolist(),
                "valid": valid.tolist(),
                "coord_id": coord.tolist(),
                "n_nodes": nn.tolist(),
                # Per-pose observability (sigma_min of the localization
                # Jacobian): near-zero marks a pose the corners cannot
                # constrain — clients should gate on it, not on rms.
                "pose_obs": [round(float(v), 4) for v in obs],
                "latency_ms": round(dt * 1e3, 2),
            }

    socketserver.ThreadingTCPServer.allow_reuse_address = True
    srv = socketserver.ThreadingTCPServer((host, port), Handler)
    return srv


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="aprilslam-torch-serve",
                                 description="Persistent SLAM service (PyTorch/CUDA)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7444)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--resolution", type=int, default=1000)
    ap.add_argument("--channels", type=int, choices=(1, 3), default=1)
    ap.add_argument("--family", default="tagStandard41h12")
    ap.add_argument("--tag-size", type=float, default=10.0)
    ap.add_argument("--fov-y", type=float, default=45.0,
                    help="used when no calibration file is given")
    ap.add_argument("--calibration", default=None,
                    help=".npz intrinsics (fx fy cx cy via camera_matrix)")
    ap.add_argument("--estimator", default="ba",
                    choices=("reference_chain", "chain_avg", "joint", "ba"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda raises when no GPU is present")
    args = ap.parse_args(argv)

    from ..device import resolve_device

    dev = resolve_device(args.device)

    import numpy as np

    from ..geometry import PinholeCamera

    if args.calibration:
        z = np.load(args.calibration)
        K = np.asarray(z["camera_matrix"])
        cam = PinholeCamera(fx=float(K[0, 0]), fy=float(K[1, 1]),
                            cx=float(K[0, 2]), cy=float(K[1, 2]),
                            width=args.resolution, height=args.resolution)
    else:
        cam = PinholeCamera.from_fov(args.resolution, args.resolution, args.fov_y)

    print(f"[serve] warming the step on {dev} for batch={args.batch} "
          f"res={args.resolution} ch={args.channels} ...", file=sys.stderr,
          flush=True)
    srv = make_server(args.host, args.port, cam, args.family, args.tag_size,
                      args.batch, args.resolution, args.channels,
                      estimator=args.estimator, device=dev)
    print(f"[serve] listening on {args.host}:{args.port}", file=sys.stderr,
          flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
