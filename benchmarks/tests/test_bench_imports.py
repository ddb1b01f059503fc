"""What a fresh interpreter holds after importing the harness and the
reference: no module whose top-level name is jax, jaxlib, flax or
zero_tig_tpu; and the reference alone holds none of the port either."""

import json
import subprocess
import sys

import harness

LOAD_ALL = """
import json, sys
sys.path[:0] = [{bench!r}, {root!r}]
import harness, check, flops, frames, roofline, trace, weights, reference
for path in sorted((harness.BENCH / "drivers").glob("*.py")) + sorted((harness.BENCH / "metrics").glob("*.py")):
    harness.load_module(path, "m_" + path.stem.replace(".", "_"))
{extra}
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def top_level(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_reference_import_no_jax():
    mods = top_level(LOAD_ALL.format(bench=str(harness.BENCH), root=str(harness.ROOT),
                                     extra="import zero_tig_torch.pipeline.steps, zero_tig_torch.models"))
    assert not mods & {"jax", "jaxlib", "flax", "zero_tig_tpu"}
    assert "zero_tig_torch" in mods  # the program under test, loaded as the drivers load it


def test_reference_imports_nothing_of_the_port():
    code = (f"import json, sys\nsys.path[:0] = [{str(harness.BENCH)!r}]\nimport reference, reference.train\n"
            "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))")
    mods = top_level(code)
    assert not mods & {"jax", "jaxlib", "flax", "zero_tig_tpu", "zero_tig_torch"}
