"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program. Module names are compared by
their top-level name, whole: the port's name begins with the JAX
package's."""

import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "salva_tpu"}


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    bad = {str(f): top_level_imports(f) & FORBIDDEN for f in files}
    assert not {f: n for f, n in bad.items() if n}


def test_the_reference_imports_nothing_of_the_program():
    for f in sorted((BENCH / "reference").rglob("*.py")):
        names = top_level_imports(f)
        assert "salva_tpu_torch" not in names and not names & FORBIDDEN, f
        assert names <= {"__future__", "dataclasses", "math", "numpy",
                         "torch"}, (f, names)


def test_a_process_that_loads_the_harness_holds_no_jax():
    code = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "from benchmark import harness, check, trace, roofline, calibrate\n"
        "import benchmark.scenes.basic3_box, benchmark.solvers.dfsph, benchmark.parts\n"
        "import salva_tpu_torch.scenes, salva_tpu_torch.parallel\n"
        "for p in (harness.BENCH_DIR / 'metrics').glob('*.py'):\n"
        "    harness.metric_reader(p.stem)\n"
        "print(harness.forbidden_modules_loaded())\n"
    )
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, timeout=300,
                         check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
