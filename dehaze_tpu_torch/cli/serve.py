"""HTTP dehazing endpoint on the PyTorch/CUDA port.

    python -m dehaze_tpu_torch.cli.serve --weights w.pth [--port N]
        [--precompile 1200x1600] [--square] [--max_batch 4]
    python -m dehaze_tpu_torch.cli.serve --exported model.dhz \
        [--precompile auto]

    POST /dehaze   body = PNG, JPEG or BMP → dehazed PNG (EXIF upright)
    GET  /healthz  → JSON {status, arch, served, device, max_batch,
                    u8_input, batch_hist, geometry (--exported)}

Counterpart of `dehaze_tpu/cli/serve.py`. Handler threads decode and
encode; one device worker thread runs the forwards and MICRO-BATCHES
same-geometry requests that queued while a forward was in flight (up to
`--max_batch`); a lone request runs at once. With `--weights`, forwards
are built per request geometry and LRU-cached (`--max_geometries`;
FFA-Net's run each frame at its own resolution, with no canvas); with
`--exported` (a `cli.export` artifact), requests must have the artifact's
baked geometry (400 otherwise) and are served one at a time (the artifact
bakes batch 1). Decoded frames are capped at `--max_pixels`. `--precompile
HxW` (or `auto`: the artifact's geometry) runs one warm-up forward before
serving, which also builds the CUDA kernels.
"""

from __future__ import annotations

import argparse
import collections
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from dehaze_tpu_torch.cli.common import (add_common_args, config_from_args,
                                         one_process, resolve_forward)
from dehaze_tpu_torch.data.images import decode_img, encode_img
from dehaze_tpu_torch.infer.tiled import (make_native_image_fn,
                                          make_whole_image_fn, quantize_u8)


class MicroBatcher:
    """Group same-geometry requests queued behind the single device into one
    batched forward. No timed window: a batch forms only from requests that
    piled up while a previous forward ran. Requests of another geometry than
    the group's head go back to the queue. `hist` counts forwards by batch
    size."""

    _STOP = object()

    def __init__(self, get_run, max_batch: int):
        self.get_run = get_run
        self.max_batch = max(1, max_batch)
        self.q = queue.SimpleQueue()
        self.hist = collections.Counter()  # batch size -> forward count
        self.info = None
        self._closed = False
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def submit(self, img: np.ndarray) -> np.ndarray:
        # reject after close(); while waiting, poll the worker's liveness so
        # a dead worker fails pending requests instead of hanging them
        if self._closed:
            raise RuntimeError("server is shutting down")
        item = {"img": img, "ev": threading.Event(), "out": None, "err": None}
        self.q.put(item)
        while not item["ev"].wait(timeout=1.0):
            if not self._worker.is_alive() and not item["ev"].is_set():
                raise RuntimeError("device worker died; request not served")
        if item["err"] is not None:
            raise item["err"]
        return item["out"]

    def close(self):
        self._closed = True
        self.q.put(self._STOP)
        self._worker.join(timeout=5)
        # fail anything still queued so its handler thread unblocks
        while True:
            try:
                it = self.q.get_nowait()
            except queue.Empty:
                break
            if it is self._STOP:
                continue
            it["err"] = RuntimeError("server shut down before serving "
                                     "request")
            it["ev"].set()

    def _drain_group(self, head):
        """head + up to max_batch-1 already-queued same-geometry requests."""
        group, requeue = [head], []
        while len(group) < self.max_batch:
            try:
                nxt = self.q.get_nowait()
            except queue.Empty:
                break
            if nxt is self._STOP:
                requeue.append(nxt)  # keep shutdown for the outer loop
                break
            if nxt["img"].shape[:2] == head["img"].shape[:2]:
                group.append(nxt)
            else:
                requeue.append(nxt)
        for it in requeue:
            self.q.put(it)
        return group

    def _loop(self):
        while True:
            head = self.q.get()
            if head is self._STOP:
                return
            group = self._drain_group(head)
            try:
                h, w = head["img"].shape[:2]
                run = self.get_run(h, w)
                outs = run(np.stack([g["img"] for g in group])).cpu().numpy()
                self.hist[len(group)] += 1
                if self.info is not None:
                    self.info["served"] += len(group)
                for g, o in zip(group, outs):
                    g["out"] = o
                    g["ev"].set()
            except Exception as e:  # noqa: BLE001 — surfaces per request
                for g in group:
                    g["err"] = e
                    g["ev"].set()


def build_dehaze_fn(args, cfg):
    """→ (dehaze(img) -> uint8 RGB, info dict); split from main() for
    in-process use."""
    fwd = resolve_forward(args, cfg)
    exported = fwd.mode == "exported"
    info = {"arch": fwd.meta["arch"] if exported else cfg.arch, "served": 0,
            "device": str(fwd.device)}
    # live weights normalize uint8 on the device (4x fewer bytes to the
    # card); an artifact bakes a float32 input, so it keeps the host /255
    info["u8_input"] = not exported and getattr(args, "u8_transfer", True)
    max_geoms = max(1, getattr(args, "max_geometries", 8))
    runs = collections.OrderedDict()  # LRU: geometry -> quantized forward

    if exported:
        info["geometry"] = list(fwd.baked_hw)
        exported_u8 = quantize_u8(fwd.base_fn)

        def get_run(h, w):
            if (h, w) != fwd.baked_hw:
                raise ValueError(
                    f"frame is {h}x{w} but the exported artifact bakes "
                    f"{fwd.baked_hw[0]}x{fwd.baked_hw[1]}")
            return exported_u8
    else:
        def get_run(h, w):
            if (h, w) in runs:
                runs.move_to_end((h, w))
            else:
                runs[(h, w)] = quantize_u8(
                    make_native_image_fn(fwd.apply_fn, device=fwd.device)
                    if fwd.is_ffa else make_whole_image_fn(
                        fwd.apply_fn, h, w, args.train_ps,
                        square=getattr(args, "square", False),
                        device=fwd.device))
                while len(runs) > max_geoms:
                    runs.popitem(last=False)
            return runs[(h, w)]

    max_pixels = getattr(args, "max_pixels", 33_554_432)
    # the artifact bakes batch 1: micro-batching with --weights only
    info["max_batch"] = (1 if exported
                         else max(1, getattr(args, "max_batch", 4)))
    batcher = MicroBatcher(get_run, info["max_batch"])
    info["batch_hist"] = batcher.hist
    batcher.info = info  # the single worker thread owns the served counter

    def dehaze(img: np.ndarray) -> np.ndarray:
        h, w = img.shape[:2]
        if h * w > max_pixels:
            raise ValueError(f"decoded frame {h}x{w} exceeds the "
                             f"--max_pixels cap ({max_pixels})")
        return batcher.submit(img)

    dehaze.batcher = batcher
    return dehaze, info


def make_handler(dehaze, info):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # no per-request stderr lines
            pass

        def _send(self, code, body, ctype):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                # snapshot: the worker mutates batch_hist concurrently
                payload = {"status": "ok", **info}
                payload["batch_hist"] = dict(payload["batch_hist"].copy())
                self._send(200, json.dumps(payload).encode(),
                           "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path != "/dehaze":
                self._send(404, b"not found", "text/plain")
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                if not 0 < n <= 256 * 1024 * 1024:
                    self._send(400, b"missing or oversized body",
                               "text/plain")
                    return
                out = dehaze(decode_img(self.rfile.read(n),
                                        u8=info["u8_input"]))
                body, code, ctype = encode_img(out), 200, "image/png"
            except ValueError as e:  # undecodable / geometry / cap
                body, code, ctype = str(e).encode(), 400, "text/plain"
            except Exception as e:  # forward failure: answer, keep socket
                body = f"{type(e).__name__}: {e}".encode()
                code, ctype = 500, "text/plain"
            self._send(code, body, ctype)

    return Handler


def build_parser() -> argparse.ArgumentParser:
    p = add_common_args(argparse.ArgumentParser(description="dehaze server "
                                                 "(PyTorch/CUDA port)"))
    p.add_argument("--weights", default=None,
                   help=".pth, .pt or .pk checkpoint")
    p.add_argument("--exported", default=None,
                   help="serve a cli.export artifact instead of --weights")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8350)
    p.add_argument("--square", action="store_true",
                   help="reference square-canvas protocol (default: rect)")
    p.add_argument("--max_pixels", type=int, default=33_554_432,
                   help="reject decoded frames above this pixel count")
    p.add_argument("--max_geometries", type=int, default=8,
                   help="LRU cap on per-geometry forwards")
    p.add_argument("--max_batch", type=int, default=4,
                   help="micro-batching cap for same-geometry requests "
                        "(--exported always serves one at a time)")
    p.add_argument("--precompile", default=None,
                   help="one warm-up forward before serving (also builds "
                        "the CUDA kernels): HxW, or 'auto' for the baked "
                        "geometry of --exported")
    return p


def warm_up(dehaze, info, spec: str) -> float:
    """Run one forward at geometry 'HxW' ('auto': the artifact's baked
    geometry); returns its seconds."""
    if spec == "auto":
        if "geometry" not in info:
            raise SystemExit("--precompile auto needs --exported (no baked "
                             "geometry otherwise); pass --precompile HxW")
        wh, ww = info["geometry"]
    else:
        try:
            wh, ww = (int(v) for v in spec.lower().split("x"))
        except ValueError:
            raise SystemExit(f"--precompile expects 'auto' or HxW, got "
                             f"{spec!r}") from None
    t0 = time.perf_counter()
    dehaze(np.zeros((wh, ww, 3),
                    np.uint8 if info["u8_input"] else np.float32))
    info["served"] = 0  # the warm-up is not traffic
    info["batch_hist"].clear()
    return time.perf_counter() - t0


def main():
    args = build_parser().parse_args()
    one_process(args, "cli.serve")
    dehaze, info = build_dehaze_fn(args, config_from_args(args).model)
    if args.precompile:
        secs = warm_up(dehaze, info, args.precompile)
        print(f"warmed {args.precompile} in {secs:.1f}s", flush=True)
    server = ThreadingHTTPServer((args.host, args.port),
                                 make_handler(dehaze, info))
    print(f"serving {info['arch']} on http://{args.host}:"
          f"{server.server_port} (POST /dehaze, GET /healthz)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        dehaze.batcher.close()


if __name__ == "__main__":
    main()
