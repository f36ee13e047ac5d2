"""Entry points of the port: the one-card encode step and a multi-process
dry run; the counterpart of ``__graft_entry__.py``.

``entry(device=None)``           — ``(fn, (frames,))``: the routed pack of
                                   4 x 512x512 uint16 frames on the device
                                   (the card by default).
``dryrun_multichip(n, device=None)`` — ``n`` ranks, each a fresh
                                   interpreter in one gloo process group on
                                   localhost, run one full sharded encode
                                   and decode on tiny shapes and hold it to
                                   the spec-as-code codec's bytes.

    python -m trpx_tpu_torch.graft_entry

runs ``entry()`` and then ``dryrun_multichip(max(2, cards))`` and prints
``dryrun_multichip OK``. Nothing here changes process-global state (the
ranks get their environment from the launcher), so the two may run in
either order.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from . import api as _api
from .format import pycodec
from .io.trpx import read_trpx
from .ops import (
    decode_batch,
    decode_batch_tiled,
    encode_batch,
    encode_batch_tiled,
)
from .ops.coding import FrameSpec, assemble_archive, pack_kernel, walk_archive
from .ops.cuda_unpack import decoded_dtype
from .parallel import ShardedCodec, decode_sharded
from .parallel.codec import _split
from .parallel.distributed import init_from_env, write_shard_file

#: seconds the launcher waits for its ranks, and the ranks' gloo timeout
RANK_TIMEOUT_S = 600.0
GLOO_TIMEOUT_S = 120.0
#: tiled check: tiles of this many blocks over 3 tiles with a partial tail
TILE_BLOCKS = 128


def entry(device=None):
    """Return ``(fn, (frames,))``: ``fn(batch)`` is the routed pack
    (``ops.coding.pack_kernel``) of a (4, n_padded) batch of 512x512
    uint16 frames, returning ``(words, bits, maxw)``; ``frames`` is the
    JAX entry's example batch (``default_rng(0).poisson(3.0)``, zero past
    ``n``) on ``device`` (None: the card, RuntimeError without one)."""
    dev = _api._torch_device(device)
    spec = FrameSpec.for_dtype(512 * 512, np.uint16)
    rng = np.random.default_rng(0)
    frames = rng.poisson(3.0, size=(4, spec.n_padded)).astype(np.uint16)
    frames[:, spec.n:] = 0
    pack = pack_kernel(spec, frames.shape[0])

    def fn(batch):
        return pack(spec, batch)

    return fn, (torch.from_numpy(frames).to(dev),)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device=None) -> list[dict]:
    """Run the sharded pipeline in `n_devices` ranks, each ``python -m
    trpx_tpu_torch.graft_entry --rank R N DIR DEVICE`` in a fresh
    interpreter, joined in a gloo group at a free localhost port
    (``parallel.distributed.init_from_env``). Rank r runs on
    ``cuda:(r % cards)`` (ranks share a card when there are fewer cards),
    or on the CPU with ``device="cpu"`` (the kernels' plain versions);
    None means the card and raises RuntimeError without one. Raises unless
    every rank passes :func:`_rank_checks`; returns each rank's kernel
    launch counts."""
    dev = _api._torch_device(device)
    if n_devices < 1:
        raise ValueError(f"need at least one rank, got {n_devices}")
    port = _free_port()
    root = Path(__file__).resolve().parent.parent
    with tempfile.TemporaryDirectory() as d:
        procs = []
        for r in range(n_devices):
            env = dict(os.environ, MASTER_ADDR="localhost",
                       MASTER_PORT=str(port), RANK=str(r),
                       WORLD_SIZE=str(n_devices))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "trpx_tpu_torch.graft_entry",
                 "--rank", str(r), str(n_devices), d, dev.type],
                cwd=root, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        try:
            outs = [p.communicate(timeout=RANK_TIMEOUT_S) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    if any(p.returncode for p in procs):
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) failed: rank exit codes "
            f"{[p.returncode for p in procs]}\n" + "\n".join(
                f"rank {r}: {o[-2000:]}\n{e[-4000:]}"
                for r, (o, e) in enumerate(outs)))
    return [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]


def _rank_checks(rank: int, world: int, workdir: Path, dev) -> None:
    """One rank's share of the dry run (the checks of
    ``__graft_entry__.dryrun_multichip``, with the same data): sharded
    encodes into shared files equal to pycodec's bytes (uint16 with an
    overflow block, int16), ``decode_sharded`` over `world` devices, a
    foreign archive through the serial walk, and the tiled kernels at
    ``TILE_BLOCKS``-block tiles."""
    devices = ([torch.device("cuda", i % torch.cuda.device_count())
                for i in range(world)] if dev.type == "cuda"
               else [dev] * world)
    n = 50  # tiny frames with a partial final block (50 % 12 != 0)
    rng = np.random.default_rng(1)
    frames = rng.poisson(3.0, size=(2 * world + 1, n)).astype(np.uint16)
    frames[0, 3] = 60000  # overflow block
    sframes = rng.integers(-900, 900, size=(world + 1, n), dtype=np.int16)
    sframes[0, 0] = -512  # signed widths and sign extension

    for name, fr in (("u16", frames), ("i16", sframes)):
        spec = FrameSpec.for_dtype(n, fr.dtype)
        # every rank holds frames: 2 * world + 1 and world + 1 of them
        lo, hi = _split(len(fr), world)[rank]
        codec = ShardedCodec(spec, [devices[rank]])
        res = codec.encode_shards(fr[lo:hi], len(fr))
        path = workdir / f"{name}.trpx"
        write_shard_file(path, res, spec, len(fr))
        dist.barrier()
        host = pycodec.encode(list(fr))
        if path.read_bytes() != host.to_bytes():
            raise AssertionError(f"sharded {name} archive mismatch")
        # the shared file with the gathered frame offsets: the indexed walk
        arch = read_trpx(path)
        arch.frame_index = res.offsets
        if not np.array_equal(decode_sharded(arch, fr.dtype, devices), fr):
            raise AssertionError(f"sharded {name} round trip mismatch")
        # a foreign archive (no frame index or sidecar) takes the serial
        # header walk
        foreign = pycodec.TrpxArchive.from_bytes(host.to_bytes())
        if foreign.frame_index is not None or not np.array_equal(
                decode_sharded(foreign, fr.dtype, devices), fr):
            raise AssertionError(f"sharded foreign {name} decode mismatch")

    # tiled kernels at TILE_BLOCKS-block tiles: 3 tiles, a partial tail
    # block, the width chain and bit count carried across tiles
    nt = TILE_BLOCKS * 12 * 2 + 100
    tframes = rng.poisson(3.0, size=(2, nt)).astype(np.uint16)
    tframes[0, 5] = 60000
    tspec = FrameSpec.for_dtype(nt, np.uint16)
    padded = np.zeros((2, tspec.n_padded), np.uint16)
    padded[:, :nt] = tframes
    d = devices[rank]
    w, b, m = encode_batch_tiled(tspec, torch.from_numpy(padded).to(d),
                                 TILE_BLOCKS)
    tarch = assemble_archive(tspec, w.cpu().numpy().view(np.uint32),
                             b.cpu().numpy(), m.cpu().numpy())
    if tarch.payload != pycodec.encode(list(tframes)).payload:
        raise AssertionError("tiled archive mismatch")
    widths, words = walk_archive(tarch, tspec)
    out = decode_batch_tiled(
        tspec, torch.from_numpy(words.view(np.int32)).to(d),
        torch.from_numpy(widths).to(d),
        decoded_dtype(tspec), TILE_BLOCKS)
    if not np.array_equal(out.cpu().numpy(), tframes):
        raise AssertionError("tiled decode mismatch")


def _rank_main(rank: int, world: int, workdir: str, device: str) -> int:
    """A rank of :func:`dryrun_multichip`: join the group, run the checks,
    print the kernels' launch counts as the last line."""
    if not init_from_env(timeout_s=GLOO_TIMEOUT_S):
        raise RuntimeError("no process group from the environment")
    _rank_checks(rank, world, Path(workdir), torch.device(device))
    dist.barrier()
    dist.destroy_process_group()
    print(json.dumps({
        "rank": rank,
        "launches": {"pack": encode_batch.launches,
                     "pack_tiled": encode_batch_tiled.launches,
                     "unpack": decode_batch.launches,
                     "unpack_tiled": decode_batch_tiled.launches}}))
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--rank"]:
        rank, world, workdir, device = argv[1:5]
        return _rank_main(int(rank), int(world), workdir, device)
    fn, args = entry()
    words, bits, maxw = fn(*args)
    torch.cuda.synchronize()
    print(f"entry: routed pack of {tuple(args[0].shape)} "
          f"{args[0].dtype} on {args[0].device}: bits {bits.tolist()}, "
          f"largest widths {maxw.tolist()}")
    dryrun_multichip(max(2, torch.cuda.device_count()))
    print("dryrun_multichip OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
