"""PyTorch port: importing every module of ``trpx_tpu_torch``, and
``chip_smoke`` as a module (without running it), loads nothing of the JAX
package and not ``jax``. The imports run in a subprocess, so what the
test workers have already imported does not count.
"""

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_CODE = """
import importlib, json, pkgutil, sys
import trpx_tpu_torch
names = [m.name for m in pkgutil.walk_packages(trpx_tpu_torch.__path__,
                                                 'trpx_tpu_torch.')]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert callable(chip_smoke.main)
loaded = sorted(sys.modules)
print(json.dumps({"walked": names, "loaded": loaded}))
"""


def _imported():
    r = subprocess.run([sys.executable, "-c", _CODE], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_port_and_chip_smoke_load_nothing_of_the_jax_package():
    got = _imported()
    foreign = [m for m in got["loaded"]
               if m in ("jax", "trpx_tpu") or m.startswith(("jax.",
                                                            "trpx_tpu."))]
    assert foreign == []
    # every module file of the package was imported
    files = {".".join(p.relative_to(REPO).with_suffix("").parts)
             for p in (REPO / "trpx_tpu_torch").rglob("*.py")
             if "_build" not in p.parts[:-1]}
    files = {f.removesuffix(".__init__") for f in files}
    assert files - {"trpx_tpu_torch"} <= set(got["walked"])
    assert {"trpx_tpu_torch.format.pycodec", "trpx_tpu_torch.io.trpx",
            "trpx_tpu_torch.native.codec", "chip_smoke"} <= set(
                got["loaded"])
