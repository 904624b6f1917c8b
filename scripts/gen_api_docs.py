#!/usr/bin/env python
"""Generate docs/api/*.md from package docstrings.

The reference ships a Sphinx API site (`docs/source/api/`); tike-tpu keeps
the docs toolchain dependency-free by rendering module/function/class
docstrings into plain markdown. Regenerate after API changes:

    JAX_PLATFORMS=cpu python scripts/gen_api_docs.py
"""

import dataclasses
import importlib
import inspect
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Public modules, grouped into one page per subsystem.
PAGES = {
    "ptycho": [
        "tike_tpu.ptycho.ptycho",
        "tike_tpu.ptycho.solvers.options",
        "tike_tpu.ptycho.solvers.rpie",
        "tike_tpu.ptycho.solvers.lstsq",
        "tike_tpu.ptycho.object",
        "tike_tpu.ptycho.probe",
        "tike_tpu.ptycho.position",
        "tike_tpu.ptycho.exitwave",
        "tike_tpu.ptycho.io",
        "tike_tpu.ptycho.fresnel",
        "tike_tpu.ptycho.learn",
    ],
    "lamino": [
        "tike_tpu.lamino.lamino",
        "tike_tpu.lamino.bucket",
        "tike_tpu.lamino.solvers.cgrad",
        "tike_tpu.lamino.solvers.bucket",
    ],
    "align": [
        "tike_tpu.align.align",
        "tike_tpu.align.solvers.cross_correlation",
        "tike_tpu.align.solvers.farneback",
    ],
    "admm": ["tike_tpu.admm"],
    "operators": [
        "tike_tpu.ops.patch",
        "tike_tpu.ops.ptycho",
        "tike_tpu.ops.propagation",
        "tike_tpu.ops.objective",
        "tike_tpu.ops.usfft",
        "tike_tpu.ops.lamino",
        "tike_tpu.ops.bucket",
        "tike_tpu.ops.flow",
        "tike_tpu.ops.interp",
        "tike_tpu.ops.rotate",
        "tike_tpu.ops.shift",
        "tike_tpu.ops.pad",
        "tike_tpu.ops.alignment",
    ],
    "parallel": [
        "tike_tpu.parallel",
        "tike_tpu.parallel.striped",
        "tike_tpu.parallel.halo",
        "tike_tpu.parallel.distributed",
        "tike_tpu.cluster",
    ],
    "support": [
        "tike_tpu.opt",
        "tike_tpu.linalg",
        "tike_tpu.scan",
        "tike_tpu.trajectory",
        "tike_tpu.constants",
        "tike_tpu.precision",
        "tike_tpu.random",
        "tike_tpu.checkpoint",
        "tike_tpu.view",
        "tike_tpu.runtime",
    ],
}

PAGE_TITLES = {
    "ptycho": "Ptychography (`tike_tpu.ptycho`)",
    "lamino": "Laminography (`tike_tpu.lamino`)",
    "align": "Alignment (`tike_tpu.align`)",
    "admm": "Joint ptycho-tomography ADMM (`tike_tpu.admm`)",
    "operators": "Operators (`tike_tpu.ops`)",
    "parallel": "Parallelism (`tike_tpu.parallel`)",
    "support": "Support utilities",
}


def _public_members(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in vars(mod) if not n.startswith("_")]
    out = []
    for n in names:
        obj = getattr(mod, n, None)
        if obj is None:
            continue
        if inspect.ismodule(obj):
            continue
        owner = getattr(obj, "__module__", None)
        # Keep only members defined in this module (avoid re-export dupes
        # across pages) unless the module declares __all__.
        if getattr(mod, "__all__", None) is None and owner != mod.__name__:
            continue
        if inspect.isfunction(obj) or inspect.isclass(obj):
            out.append((n, obj))
    return out


class _Name:
    """A function or module default, shown by its name: its repr holds a
    memory address or an install path, which change from run to run."""

    def __init__(self, obj):
        self.name = obj.__name__

    def __repr__(self):
        return self.name


def _signature(obj):
    try:
        sig = inspect.signature(obj)
    except (ValueError, TypeError):
        return "(...)"
    return str(sig.replace(parameters=[
        p.replace(default=_Name(p.default))
        if inspect.isfunction(p.default) or inspect.ismodule(p.default)
        else p
        for p in sig.parameters.values()
    ]))


def _doc(obj):
    d = inspect.getdoc(obj)
    return d.strip() if d else ""


def _render_class(name, cls):
    lines = [f"### `{name}{_signature(cls)}`", ""]
    doc = _doc(cls)
    if doc:
        lines += [doc, ""]
    if dataclasses.is_dataclass(cls):
        lines.append("| field | default |")
        lines.append("|---|---|")
        for f in dataclasses.fields(cls):
            if f.default is not dataclasses.MISSING:
                default = repr(f.default)
            elif f.default_factory is not dataclasses.MISSING:  # type: ignore
                default = f"{getattr(f.default_factory, '__name__', '...')}()"
            else:
                default = "(required)"
            if len(default) > 40:
                default = default[:37] + "..."
            lines.append(f"| `{f.name}` | `{default}` |")
        lines.append("")
    for mname, meth in inspect.getmembers(cls, inspect.isfunction):
        if mname.startswith("_"):
            continue
        if meth.__qualname__.split(".")[0] != cls.__name__:
            continue
        mdoc = _doc(meth)
        first = mdoc.splitlines()[0] if mdoc else ""
        lines.append(f"- **`.{mname}{_signature(meth)}`** — {first}")
    if lines[-1] != "":
        lines.append("")
    return lines


def _render_module(modname):
    mod = importlib.import_module(modname)
    lines = [f"## `{modname}`", ""]
    doc = _doc(mod)
    if doc:
        lines += [doc, ""]
    for name, obj in _public_members(mod):
        if inspect.isclass(obj):
            lines += _render_class(name, obj)
        else:
            lines.append(f"### `{name}{_signature(obj)}`")
            lines.append("")
            fdoc = _doc(obj)
            if fdoc:
                lines += [fdoc, ""]
    return lines


def main():
    import jax

    try:
        jax.config.update("jax_platforms", "cpu")
    except RuntimeError:
        pass

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    outdir = os.path.join(root, "docs", "api")
    os.makedirs(outdir, exist_ok=True)
    index = [
        "# API reference",
        "",
        "Generated from docstrings by `scripts/gen_api_docs.py`; do not edit",
        "by hand. Guides live one directory up (`docs/*.md`).",
        "",
    ]
    for page, modules in PAGES.items():
        lines = [f"# {PAGE_TITLES[page]}", ""]
        lines += [
            "*Generated from docstrings by `scripts/gen_api_docs.py`;",
            "do not edit by hand.*",
            "",
        ]
        for m in modules:
            lines += _render_module(m)
        path = os.path.join(outdir, f"{page}.md")
        with open(path, "w") as f:
            f.write("\n".join(lines).rstrip() + "\n")
        index.append(f"- [{PAGE_TITLES[page]}]({page}.md)")
        print(f"wrote {path}")
    with open(os.path.join(outdir, "README.md"), "w") as f:
        f.write("\n".join(index) + "\n")
    print("wrote index")


if __name__ == "__main__":
    main()
