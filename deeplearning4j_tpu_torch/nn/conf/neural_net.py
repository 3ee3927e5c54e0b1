"""Network configuration of the serving slice (counterpart of
`deeplearning4j_tpu/nn/conf/neural_net.py`): `ComputationGraphConfiguration`
read from the reference's `to_json()`."""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.nn.conf.graph import (
    GraphVertexConf,
    vertex_from_dict,
)


@dataclass
class GlobalConf:
    """The global fields inference reads; the reference's training fields
    (updater, learning rates, ...) are read past."""

    seed: int = 12345
    weight_init: Any = "xavier"
    bias_init: float = 0.0
    activation: Any = "sigmoid"
    dtype: str = "float32"
    dtype_policy: Optional[Any] = None

    @staticmethod
    def from_dict(d: Optional[dict]) -> "GlobalConf":
        names = {f.name for f in dataclasses.fields(GlobalConf)}
        return GlobalConf(**{k: v for k, v in (d or {}).items()
                             if k in names})


@dataclass
class ComputationGraphConfiguration:
    global_conf: GlobalConf = field(default_factory=GlobalConf)
    network_inputs: List[str] = field(default_factory=list)
    network_outputs: List[str] = field(default_factory=list)
    vertices: Dict[str, GraphVertexConf] = field(default_factory=dict)
    vertex_inputs: Dict[str, List[str]] = field(default_factory=dict)

    def validate(self) -> None:
        if not self.network_inputs or not self.network_outputs:
            raise ValueError("ComputationGraph needs network inputs and "
                             "outputs")
        known = set(self.network_inputs) | set(self.vertices)
        for name, ins in self.vertex_inputs.items():
            for i in ins:
                if i not in known:
                    raise ValueError(f"Vertex {name!r} input {i!r} is not a "
                                     "known vertex/input")
        for o in self.network_outputs:
            if o not in self.vertices:
                raise ValueError(f"Network output {o!r} is not a vertex")
        self.topological_order()

    def topological_order(self) -> List[str]:
        """Kahn sort with the reference's tie order (sorted ready set)."""
        indegree = {n: 0 for n in self.vertices}
        dependents: Dict[str, List[str]] = {
            n: [] for n in list(self.vertices) + self.network_inputs}
        for name, ins in self.vertex_inputs.items():
            for i in ins:
                dependents.setdefault(i, []).append(name)
                if i in self.vertices:
                    indegree[name] += 1
        order: List[str] = []
        ready = sorted(n for n, d in indegree.items() if d == 0)
        while ready:
            n = ready.pop(0)
            order.append(n)
            for dep in dependents.get(n, []):
                indegree[dep] -= 1
                if indegree[dep] == 0:
                    ready.append(dep)
        if len(order) != len(self.vertices):
            raise ValueError("Cycle detected in ComputationGraph "
                             "configuration")
        return order

    @staticmethod
    def from_dict(d) -> "ComputationGraphConfiguration":
        conf = ComputationGraphConfiguration(
            global_conf=GlobalConf.from_dict(d.get("global_conf")),
            network_inputs=list(d["network_inputs"]),
            network_outputs=list(d["network_outputs"]),
            vertices={n: vertex_from_dict(v)
                      for n, v in d["vertices"].items()},
            vertex_inputs={n: list(v) for n, v in d["vertex_inputs"].items()},
        )
        conf.validate()
        return conf

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        return ComputationGraphConfiguration.from_dict(json.loads(s))
