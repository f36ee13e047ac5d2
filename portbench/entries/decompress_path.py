"""``trpx_tpu_torch.api.decompress(path)`` of ``.trpx`` files, each with
the v2 ``.trpx.idx`` sidecar that the reference writes beside it in the
run's temporary directory. Set-up confirms that the program takes the
sidecar's tables (``io.read_trpx`` carries ``width_table``)."""

from __future__ import annotations

from portbench import reference
from portbench.cells import DecodeCell


class Cell(DecodeCell):
    def __init__(self, ctx) -> None:
        super().__init__(ctx)
        from trpx_tpu_torch import api
        from trpx_tpu_torch.io import read_trpx

        self._decompress = api.decompress
        self.paths = []
        for k, a in enumerate(self.archives):
            p = ctx.tmpdir / f"input{k}.trpx"
            with self.by_reference():
                p.write_bytes(a.to_bytes())
                p.with_name(p.name + ".idx").write_bytes(
                    reference.sidecar_bytes(a))
            if getattr(read_trpx(p), "width_table", None) is None:
                raise RuntimeError(f"the program does not take the sidecar of {p}")
            self.paths.append(str(p))

    def call(self, k: int):
        return self._decompress(self.paths[k % self.distinct],
                                device=self.ctx.device_arg)
