"""The syntax tree of a module the port copies from the JAX package, made
comparable with the reference's (not a test file; shared by the test files
that hold the port's numpy copies to the reference).

Module, class and function docstrings are dropped, and the package's name
is written ``PKG`` in ``from`` imports and in the layout advice's module
name (the one intended difference in an anomaly's text), so that
``tree("repro_torch", rel) == tree("repro", rel)`` holds exactly when the
port's copy is the same code.

``DECLARED`` lists the port's other intended differences, by module: a
constant of the port's written as the reference's.  They are the
simulator's: ``program_from_config`` defaults to the H100's bf16 peak
(989e12 FLOP/s, where the reference's default is a TPU's 197e12), and the
Case-1 injector names its span ``torch.cuda@synchronize`` (the reference's
``jax@block_until_ready``).
"""
import ast
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

DECLARED = {
    "core/timeline.py": {989e12: 197e12},
    "core/injectors/builtins.py": {
        "torch.cuda@synchronize": "jax@block_until_ready"},
}


class _Normalised(ast.NodeTransformer):
    """Drops module, class and function docstrings and writes ``pkg`` as
    ``PKG`` in ``from`` imports and in the layout advice's module name."""

    def __init__(self, pkg: str, declared: dict | None = None):
        self.pkg = pkg
        self.declared = declared or {}

    def _drop_docstring(self, node):
        self.generic_visit(node)
        body = node.body
        if (body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
        return node

    visit_Module = visit_ClassDef = _drop_docstring
    visit_FunctionDef = visit_AsyncFunctionDef = _drop_docstring

    def visit_ImportFrom(self, node):
        m = node.module or ""
        if m == self.pkg or m.startswith(self.pkg + "."):
            node.module = "PKG" + m[len(self.pkg):]
        return node

    def visit_Constant(self, node):
        if (type(node.value) in (str, float)
                and node.value in self.declared):
            node.value = self.declared[node.value]
            return node
        advice = f"{self.pkg}.kernels.padded_matmul"
        if isinstance(node.value, str) and advice in node.value:
            node.value = node.value.replace(advice,
                                            "PKG.kernels.padded_matmul")
        return node


def tree(pkg: str, rel: str, declared: bool = True) -> str:
    """The normalised syntax tree of ``src/<pkg>/<rel>``, dumped; the
    port's ``DECLARED`` constants of ``rel`` written as the reference's
    unless ``declared`` is False."""
    text = (SRC / pkg / rel).read_text()
    names = DECLARED.get(rel, {}) if declared and pkg == "repro_torch" \
        else {}
    return ast.dump(_Normalised(pkg, names).visit(ast.parse(text)))
