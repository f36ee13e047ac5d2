"""PyTorch port, multi-process encode: two real processes in one gloo
process group (``parallel.distributed.init_from_env`` on
``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE``), each encoding
its own frame shard on ``device="cpu"`` (the kernels' plain versions) into
ONE shared ``.trpx`` through ``ShardedCodec.encode_shards`` (the gathered
size table) and ``write_shard_file``: the counterpart of
``tests/test_multiprocess.py``. Tolerance: exact. The shared file must
equal the JAX package's ``pycodec`` bytes; crash recovery, the stream's
kill-and-resume drill and a barrier against a dead peer are covered too.

Run as a script, this file is the worker:

    python tests/test_torch_multiprocess.py MODE RANK WORLD PORT OUT DEVICE

with MODE ``shard`` (the shared-file encode), ``stream`` (the chunked
``StreamingShardEncoder``) or ``dead`` (rank 1 dies inside its first
chunk). It imports nothing of JAX.
"""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

WORKER = Path(__file__).resolve()
REPO = WORKER.parent.parent
#: gloo timeout of the workers' process group, seconds
TIMEOUT_S = 60.0
DEAD_PEER_TIMEOUT_S = 20.0


def shard_frames(dtype=np.uint16):
    """The shared-file encode's 24 frames of 600 values (partial last
    block), Poisson(3) with hot pixels."""
    F, n = 24, 600
    rng = np.random.default_rng(123)
    frames = rng.poisson(3.0, size=(F, n)).astype(dtype)
    frames[rng.random((F, n)) < 0.002] = np.iinfo(dtype).max
    return frames


def stream_frames():
    """The stream drill's 32 frames of 64x64 u16."""
    F, n = 32, 64 * 64
    rng = np.random.default_rng(321)
    frames = rng.poisson(3.0, size=(F, n)).astype(np.uint16)
    frames[rng.random((F, n)) < 1e-3] = 60000
    return frames


def _counts(F: int, world: int, split: str | None) -> list[int]:
    if split:
        counts = [int(c) for c in split.split(",")]
        assert len(counts) == world and sum(counts) == F
        return counts
    return [F // world + (r < F % world) for r in range(world)]


def _launch_counts() -> dict:
    from trpx_tpu_torch.ops import (
        decode_batch,
        decode_batch_tiled,
        encode_batch,
        encode_batch_tiled,
    )

    return {"pack": encode_batch.launches,
            "pack_tiled": encode_batch_tiled.launches,
            "unpack": decode_batch.launches,
            "unpack_tiled": decode_batch_tiled.launches}


def worker(mode: str, rank: int, world: int, port: int, out: str,
           device: str) -> int:
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world))
    import torch.distributed as dist

    from trpx_tpu_torch.ops import FrameSpec
    from trpx_tpu_torch.parallel import ShardedCodec
    from trpx_tpu_torch.parallel.distributed import (
        StreamingShardEncoder,
        init_from_env,
        write_run_manifest,
        write_shard_file,
    )

    timeout = float(os.environ.get("TRPX_TEST_TIMEOUT", TIMEOUT_S))
    assert init_from_env(timeout_s=timeout)
    assert dist.get_world_size() == world and dist.get_rank() == rank
    if mode == "shard":
        frames = shard_frames()
        F, n = frames.shape
        counts = _counts(F, world, os.environ.get("TRPX_TEST_SPLIT"))
        lo = sum(counts[:rank])
        spec = FrameSpec.for_dtype(n, frames.dtype)
        res = ShardedCodec(spec, [device]).encode_shards(
            frames[lo : lo + counts[rank]], F)
        assert (res.frame_lo, res.frame_hi) == (lo, lo + counts[rank])
        crash = os.environ.get("TRPX_TEST_CRASH_RANK")
        # fault injection: the crash rank "dies" after the collective but
        # before writing its shard (recover_shard completes the file)
        if crash is None or int(crash) != rank:
            write_shard_file(out, res, spec, F)
        if rank == 0:
            write_run_manifest(out, res, spec, F, dtype=frames.dtype)
        print(json.dumps({"launches": _launch_counts()}), flush=True)
        dist.barrier()
        dist.destroy_process_group()
        return 0
    if mode == "stream":
        frames = stream_frames()
        F, n = frames.shape
        C = int(os.environ["TRPX_TEST_STREAM_CHUNK"])
        codec = ShardedCodec(FrameSpec.for_dtype(n, frames.dtype), [device])
        enc = StreamingShardEncoder(out, codec, frames.dtype)
        stop_after = os.environ.get("TRPX_TEST_STOP_AFTER_CHUNKS")
        crash = os.environ.get("TRPX_TEST_CRASH_RANK")
        lo = enc.frames_done                  # the resume point
        done = lo // C
        while lo < F:
            hi = min(F, lo + C)
            counts = _counts(hi - lo, world, None)
            a = lo + sum(counts[:rank])
            enc.add_chunk(frames[a : a + counts[rank]], hi - lo)
            lo = hi
            done += 1
            if stop_after is not None and done >= int(stop_after):
                # preemption right after a checkpoint: the crash rank dies
                # hard, the others exit without a teardown
                print(json.dumps({"launches": _launch_counts()}), flush=True)
                os._exit(3 if crash is not None and int(crash) == rank
                         else 0)
        enc.finalize()
        print(json.dumps({"launches": _launch_counts()}), flush=True)
        dist.destroy_process_group()
        return 0
    if mode == "dead":
        frames = stream_frames()[:8]
        codec = ShardedCodec(FrameSpec.for_dtype(frames.shape[1],
                                                 frames.dtype), [device])
        enc = StreamingShardEncoder(out, codec, frames.dtype)
        half = len(frames) // 2
        mine = frames[rank * half : (rank + 1) * half]
        if rank == 1:
            # dies after the size-table collectives, before its bytes are
            # durable: the coordinator's chunk barrier must raise
            os.pwrite = lambda *a: os._exit(3)
            enc.add_chunk(mine, len(frames))
            return 4
        t0 = time.perf_counter()
        try:
            enc.add_chunk(mine, len(frames))
        except Exception as e:   # the barrier's error, reported and checked
            print(json.dumps({"raised": type(e).__name__,
                              "seconds": time.perf_counter() - t0,
                              "frames_done": enc.frames_done}), flush=True)
            os._exit(5)
        return 6
    raise ValueError(f"unknown mode {mode}")


# ------------------------------------------------------------- tests ---


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(mode: str, out, device: str = "cpu", world: int = 2,
           env: dict | None = None, timeout: float = 300):
    """Run `world` workers of `mode` on a fresh port; returns
    [(returncode, stdout, stderr)] by rank, each worker's output read
    with its own timeout."""
    e = dict(os.environ)
    e["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([e["PYTHONPATH"]] if e.get("PYTHONPATH") else []))
    e.update(env or {})
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), mode, str(r), str(world), str(port),
         str(out), device],
        env=e, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
        return [(p.returncode, o, er) for p, (o, er) in zip(procs, outs)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def last_json(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])


def _jax_pycodec_bytes(frames) -> bytes:
    from trpx_tpu.format import pycodec

    return pycodec.encode(list(frames)).to_bytes()


@pytest.mark.parametrize("split", ["12,12", "5,19"])
def test_two_process_shard_encode(tmp_path, split):
    out = tmp_path / "multi.trpx"
    runs = launch("shard", out, env={"TRPX_TEST_SPLIT": split})
    for rc, o, e in runs:
        assert rc == 0, f"worker failed:\n{o}\n{e}"
    assert out.read_bytes() == _jax_pycodec_bytes(shard_frames())


def test_shard_crash_recovery(tmp_path):
    """Rank 1 dies before writing its shard; ``recover_shard`` re-encodes
    that frame range from the run manifest alone and completes the
    file; altered frames are refused."""
    from trpx_tpu_torch.parallel.distributed import recover_shard

    out = tmp_path / "crash.trpx"
    runs = launch("shard", out, env={"TRPX_TEST_CRASH_RANK": "1"})
    for rc, o, e in runs:
        assert rc == 0, f"worker failed:\n{o}\n{e}"
    ref = _jax_pycodec_bytes(shard_frames())
    assert out.read_bytes() != ref
    frames = shard_frames()
    recover_shard(out, frames[12:], frame_lo=12, device="cpu")
    assert out.read_bytes() == ref
    bad = frames[12:].copy()
    bad[0, 0] ^= 1023
    with pytest.raises(ValueError):
        recover_shard(out, bad, frame_lo=12, device="cpu")


def test_streaming_shard_resume(tmp_path):
    """Two ranks stream 32 frames in 8-frame chunks into one shared file;
    rank 1 dies hard right after the chunk-2 checkpoint; a torn tail is
    written where chunk 3 lands; the relaunched ranks resume from
    ``frames_done``, overwrite it, finalize, and the file equals the
    native codec's and ``pycodec``'s bytes."""
    from trpx_tpu_torch.native import codec as ncodec

    out = tmp_path / "movie.trpx"
    env = {"TRPX_TEST_STREAM_CHUNK": "8"}
    runs = launch("stream", out, env={**env, "TRPX_TEST_STOP_AFTER_CHUNKS":
                                      "2", "TRPX_TEST_CRASH_RANK": "1"})
    assert runs[0][0] == 0, f"coordinator:\n{runs[0][2]}"
    assert runs[1][0] == 3, f"crash rank:\n{runs[1][2]}"
    man = json.loads((tmp_path / "movie.trpx.manifest").read_text())
    assert man["frames_done"] == 16
    assert not out.exists()
    with open(tmp_path / "movie.trpx.part", "r+b") as f:
        f.seek(man["payload_bytes"])
        f.write(b"\xde\xad" * 5_000)
    runs = launch("stream", out, env=env)
    for rc, o, e in runs:
        assert rc == 0, f"resume failed:\n{o}\n{e}"
    assert not (tmp_path / "movie.trpx.part").exists()
    assert not (tmp_path / "movie.trpx.manifest").exists()
    frames = stream_frames()
    assert out.read_bytes() == ncodec.encode(frames).to_bytes()
    assert out.read_bytes() == _jax_pycodec_bytes(frames)


def test_barrier_against_dead_peer_raises(tmp_path):
    """Rank 1 dies inside its first chunk, before its bytes are durable:
    rank 0's chunk barrier raises within the group's stated timeout, and
    no checkpoint claims the chunk."""
    out = tmp_path / "dead.trpx"
    runs = launch("dead", out, env={
        "TRPX_TEST_TIMEOUT": str(DEAD_PEER_TIMEOUT_S)}, timeout=120)
    assert runs[1][0] == 3, runs[1][2]
    assert runs[0][0] == 5, f"coordinator did not raise:\n{runs[0][1:]}"
    got = last_json(runs[0][1])
    assert got["seconds"] < DEAD_PEER_TIMEOUT_S + 10
    assert got["frames_done"] == 0
    man = json.loads((tmp_path / "dead.trpx.manifest").read_text())
    assert man["frames_done"] == 0 and man["payload_bytes"] == 0
    assert not out.exists()


if __name__ == "__main__":
    a = sys.argv[1:]
    sys.exit(worker(a[0], int(a[1]), int(a[2]), int(a[3]), a[4], a[5]))
