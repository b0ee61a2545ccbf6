"""Nothing the benchmark runs imports JAX, the JAX package or its
benchmarks, and the references import nothing of the program: the
top-level name of every import in ``bench/``, compared whole."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)
NEVER = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & NEVER


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_independent_of_the_program(path):
    assert not top_level_imports(path) & (NEVER | {"repro_torch"})


def test_only_the_adapter_imports_the_program():
    users = [p.name for p in SOURCES
             if "repro_torch" in top_level_imports(p)]
    assert users == ["port.py"]


def test_names_are_compared_whole(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import repro_torch.serve\nfrom jaxtyping import x\n"
                   "import reprox\n")
    assert not top_level_imports(src) & NEVER
    src.write_text("from repro.serve import engine\n")
    assert top_level_imports(src) & NEVER == {"repro"}
