"""What the benchmark imports: never JAX or the JAX package (top-level
names compared whole, as `hqtransformer_tpu_torch` begins with
`hqtransformer_tpu`), and the reference nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'hqtransformer_tpu'}


def imported(path: Path):
    """The top-level names of the modules a Python file imports."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.')[0]


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob('*.py'))
    assert files
    for path in files:
        assert not FORBIDDEN & set(imported(path)), path


def test_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / 'reference').glob('*.py')):
        names = set(imported(path))
        assert names <= {'__future__', 'torch', 'math', 'typing',
                         'contextlib'}, (path, names)


def test_a_run_loads_no_jax_module():
    """Both drivers at tiny sizes on the CPU, then the loaded modules."""
    script = (
        'import sys, json, tiny\n'
        'from hqbench.run_context import forbidden_modules\n'
        'for kind in ("sample", "train"):\n'
        '    tiny.run(tiny.cell("tiny-l2", kind), seconds=0.0)\n'
        'print(json.dumps({"bad": forbidden_modules(),\n'
        '                  "torch": "hqtransformer_tpu_torch" in\n'
        '                  {m.split(".")[0] for m in sys.modules}}))\n')
    env_path = ':'.join([str(BENCH.parent), str(BENCH),
                         str(Path(__file__).parent)])
    done = subprocess.run([sys.executable, '-c', script], text=True,
                          capture_output=True, timeout=600,
                          env={'PYTHONPATH': env_path, 'PATH': '/usr/bin'})
    assert done.returncode == 0, done.stderr[-2000:]
    found = json.loads(done.stdout.strip().splitlines()[-1])
    assert found == {'bad': [], 'torch': True}
