"""Typed clientset generator (the port's copy of
``aigw_tpu/config/clientgen.py``).

Upstream ships generated clientsets, informers and deepcopy for its API
group (client-go codegen over ``api/v1alpha1``). This generator reads
the shipped CRD schemas (charts/aigw-tpu-crds, repository data that the
admission rules are pinned against), so the generated surface cannot
diverge from the API contract:

- a ``<Kind>Spec`` dataclass per kind, its top-level spec fields typed
  from the openAPIV3Schema (nested objects stay dicts; admission
  enforces the deep rules),
- a ``<Kind>Client`` with typed async ``list/get/patch_status`` over
  the port's ``KubeClient`` (the one wire path),
- a ``<Kind>Informer``: the add/update/delete callback contract over
  ``KubeSource``'s cache (client-go's informer),
- an aggregate ``AigwClientset``.

Run ``python -m aigw_tpu_torch.config.clientgen`` to regenerate
``aigw_tpu_torch/config/generated/clients.py`` (pyyaml reads the CRD
files; nothing else needs it); tests/test_torch_clientgen.py fails on
a stale output, as upstream's CI fails on stale zz_generated files.
"""

from __future__ import annotations

import glob
import os
from typing import Any

CRD_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "charts",
                       "aigw-tpu-crds", "templates")
OUT_PATH = os.path.join(os.path.dirname(__file__), "generated",
                        "clients.py")

_PY_TYPES = {
    "string": "str",
    "integer": "int",
    "number": "float",
    "boolean": "bool",
    "object": "dict[str, Any]",
    "array": "list[Any]",
}


def _snake(name: str) -> str:
    """Acronym-aware: AIGatewayRoute → ai_gateway_route,
    MCPRoute → mcp_route."""
    import re

    s = re.sub(r"(?<=[a-z0-9])(?=[A-Z])|(?<=[A-Z])(?=[A-Z][a-z])",
               "_", name).lower()
    return s + "_" if s in ("from", "import", "class", "type") else s


def load_crds() -> list[dict[str, Any]]:
    import yaml

    crds = []
    for path in sorted(glob.glob(os.path.join(CRD_DIR, "*.yaml"))):
        with open(path) as f:
            doc = yaml.safe_load(f)
        if isinstance(doc, dict) and doc.get("kind") == \
                "CustomResourceDefinition":
            crds.append(doc)
    return crds


def _spec_fields(crd: dict[str, Any]) -> list[tuple[str, str, str]]:
    """(json_name, python_name, python_type) for the served version's
    top-level spec properties."""
    version = crd["spec"]["versions"][0]
    props = (
        version["schema"]["openAPIV3Schema"]
        .get("properties", {})
        .get("spec", {})
        .get("properties", {})
    )
    fields = []
    for name, schema in props.items():
        fields.append((name, _snake(name),
                       _PY_TYPES.get(schema.get("type", ""), "Any")))
    return fields


def generate() -> str:
    crds = load_crds()
    out: list[str] = [
        '"""GENERATED by aigw_tpu_torch.config.clientgen — DO NOT EDIT.',
        "",
        "Typed clientset/informer surface over the shipped CRD schemas",
        "(charts/aigw-tpu-crds). Regenerate with:",
        "",
        "    python -m aigw_tpu_torch.config.clientgen",
        "",
        "tests/test_torch_clientgen.py fails when this file is stale.",
        '"""',
        "",
        "from __future__ import annotations",
        "",
        "from dataclasses import dataclass, field",
        "from typing import Any, Callable",
        "",
        "from aigw_tpu_torch.config.kube import KubeClient, KubeSource",
        "",
    ]
    kinds: list[tuple[str, str, str, str]] = []
    for crd in crds:
        spec = crd["spec"]
        kind = spec["names"]["kind"]
        group = spec["group"]
        plural = spec["names"]["plural"]
        version = spec["versions"][0]["name"]
        kinds.append((kind, group, version, plural))
        fields = _spec_fields(crd)
        out.append("")
        out.append("@dataclass")
        out.append(f"class {kind}Spec:")
        out.append(f'    """spec of {group}/{version} {kind} '
                   f'(generated)."""')
        out.append("")
        for json_name, py_name, py_type in fields:
            default = ("None" if py_type not in
                       ("dict[str, Any]", "list[Any]")
                       else "field(default_factory="
                       + ("dict)" if py_type.startswith("dict")
                          else "list)"))
            ann = (py_type if default.startswith("field")
                   else f"{py_type} | None")
            out.append(f"    {py_name}: {ann} = {default}")
        if not fields:
            out.append("    pass")
        out.append("")
        out.append("    @classmethod")
        out.append("    def from_dict(cls, spec: dict[str, Any]) "
                   f'-> "{kind}Spec":')
        out.append("        spec = spec or {}")
        out.append("        return cls(")
        for json_name, py_name, py_type in fields:
            # container fields honor their default_factory annotation:
            # absent/null must be []/{} so `for x in spec.rules` is safe
            if py_type.startswith("dict"):
                out.append(f"            {py_name}="
                           f"spec.get({json_name!r}) or {{}},")
            elif py_type.startswith("list"):
                out.append(f"            {py_name}="
                           f"spec.get({json_name!r}) or [],")
            else:
                out.append(f"            {py_name}="
                           f"spec.get({json_name!r}),")
        out.append("        )")
        out.append("")
        out.append("    def to_dict(self) -> dict[str, Any]:")
        out.append("        out: dict[str, Any] = {}")
        for json_name, py_name, _ in fields:
            out.append(f"        if self.{py_name} is not None:")
            out.append(f"            out[{json_name!r}] = "
                       f"self.{py_name}")
        out.append("        return out")
        out.append("")
        out.append("")
        out.append("@dataclass")
        out.append(f"class {kind}:")
        out.append(f'    """{group}/{version} {kind} (generated)."""')
        out.append("")
        out.append(f'    API_VERSION = "{group}/{version}"')
        out.append(f'    KIND = "{kind}"')
        out.append(f'    PLURAL = "{plural}"')
        out.append("")
        out.append("    metadata: dict[str, Any] = "
                   "field(default_factory=dict)")
        out.append(f"    spec: {kind}Spec = "
                   f"field(default_factory={kind}Spec)")
        out.append("    status: dict[str, Any] = "
                   "field(default_factory=dict)")
        out.append("    raw: dict[str, Any] = "
                   "field(default_factory=dict)")
        out.append("")
        out.append("    @classmethod")
        out.append(f'    def from_dict(cls, obj: dict[str, Any]) '
                   f'-> "{kind}":')
        out.append("        return cls(")
        out.append('            metadata=obj.get("metadata") or {},')
        out.append(f'            spec={kind}Spec.from_dict('
                   'obj.get("spec") or {}),')
        out.append('            status=obj.get("status") or {},')
        out.append("            raw=obj,")
        out.append("        )")
        out.append("")
        out.append("    @property")
        out.append("    def name(self) -> str:")
        out.append('        return self.metadata.get("name", "")')
        out.append("")
        out.append("    @property")
        out.append("    def namespace(self) -> str:")
        out.append('        return self.metadata.get("namespace") '
                   'or "default"')
        out.append("")
        out.append("")
        out.append(f"class {kind}Client:")
        out.append(f'    """Typed REST access for {kind} '
                   f'(generated)."""')
        out.append("")
        out.append("    def __init__(self, client: KubeClient):")
        out.append("        self._c = client")
        out.append("")
        out.append(f"    async def list(self) -> list[{kind}]:")
        out.append("        items, _rv, _installed = "
                   "await self._c.list_resource(")
        out.append(f'            "{kind}")')
        out.append(f"        return [{kind}.from_dict(o) "
                   "for o in items]")
        out.append("")
        out.append(f"    async def get(self, name: str, "
                   f'namespace: str = "default") -> {kind} | None:')
        out.append("        for obj in await self.list():")
        out.append("            if obj.name == name and "
                   "obj.namespace == namespace:")
        out.append("                return obj")
        out.append("        return None")
        out.append("")
        out.append("    async def patch_status(self, obj: "
                   f"{kind}, conditions: list[dict[str, Any]]) -> bool:")
        out.append("        return await self._c.patch_status("
                   "obj.raw, conditions)")
        out.append("")
        out.append("")
        out.append(f"class {kind}Informer:")
        out.append(f'    """client-go-style informer for {kind} over '
                   'the KubeSource cache (generated)."""')
        out.append("")
        out.append("    def __init__(self, source: KubeSource):")
        out.append("        self._source = source")
        out.append("        self._handlers: list[Callable"
                   f"[[str, {kind}], None]] = []")
        out.append("        source.add_listener(self._on_event)")
        out.append("")
        out.append("    def add_event_handler(self, fn: "
                   f"Callable[[str, {kind}], None]) -> None:")
        out.append('        """fn(event_type, obj); event_type in '
                   '{"ADDED", "MODIFIED", "DELETED"}."""')
        out.append("        self._handlers.append(fn)")
        out.append("")
        out.append("    def _on_event(self, etype: str, "
                   "obj: dict[str, Any]) -> None:")
        out.append(f'        if obj.get("kind") != "{kind}":')
        out.append("            return")
        out.append(f"        typed = {kind}.from_dict(obj)")
        out.append("        for fn in self._handlers:")
        out.append("            fn(etype, typed)")
        out.append("")
        out.append(f"    def store(self) -> list[{kind}]:")
        out.append('        """Current cache contents (the informer '
                   'lister)."""')
        out.append(f"        return [{kind}.from_dict(o) "
                   "for o in self._source.objects()")
        out.append(f'                if o.get("kind") == "{kind}"]')
        out.append("")

    out.append("")
    out.append("class AigwClientset:")
    out.append('    """Aggregate typed clientset over every shipped '
               'CRD kind (generated)."""')
    out.append("")
    out.append("    def __init__(self, client: KubeClient):")
    for kind, *_ in kinds:
        out.append(f"        self.{_snake(kind)} = "
                   f"{kind}Client(client)")
    out.append("")
    out.append("")
    out.append(f"ALL_KINDS = {[k for k, *_ in kinds]!r}")
    return "\n".join(out) + "\n"


def main() -> None:
    os.makedirs(os.path.dirname(OUT_PATH), exist_ok=True)
    init = os.path.join(os.path.dirname(OUT_PATH), "__init__.py")
    if not os.path.exists(init):
        with open(init, "w") as f:
            f.write("")
    code = generate()
    with open(OUT_PATH, "w") as f:
        f.write(code)
    print(f"wrote {OUT_PATH} ({len(code.splitlines())} lines)")


if __name__ == "__main__":
    main()
