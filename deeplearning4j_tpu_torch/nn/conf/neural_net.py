"""Network configurations (counterpart of
`deeplearning4j_tpu/nn/conf/neural_net.py`): `ComputationGraphConfiguration`
and `MultiLayerConfiguration`, read from the reference's `to_json()`, with
the global fields that inference and training read.
`MultiLayerConfiguration.build` is the list builder's `build()` for the
zoo: globals inherited into the layers, then, from an `InputType`, each
layer's `n_in` and the input preprocessors between layer families, as
`set_input_type` does."""

from __future__ import annotations

import copy
import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.nn.conf.graph import (
    GraphVertexConf,
    vertex_from_dict,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import Layer, layer_from_dict
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    InputPreProcessor,
    preprocessor_from_dict,
)


# Per-layer fields that inherit the global value when unset (the
# reference's `_INHERITED_FIELDS`, resolved into its JSON at build time).
INHERITED_FIELDS = (
    "activation", "weight_init", "learning_rate", "bias_learning_rate",
    "l1", "l2", "dropout", "use_drop_connect", "bias_init", "updater",
    "momentum", "adam_mean_decay", "adam_var_decay", "rho", "rms_decay",
    "epsilon", "gradient_normalization", "gradient_normalization_threshold",
)


@dataclass
class GlobalConf:
    """The reference's global fields that inference and `fit` read, with
    its defaults. Names are the reference's JSON values (lower-case
    strings for its enums)."""

    seed: int = 12345
    iterations: int = 1
    optimization_algo: Any = "stochastic_gradient_descent"
    learning_rate: float = 1e-1
    bias_learning_rate: Optional[float] = None
    lr_policy: Any = "none"
    lr_policy_decay_rate: float = 0.0
    lr_policy_power: float = 0.0
    lr_policy_steps: float = 1.0
    lr_schedule: Optional[Dict[int, float]] = None
    max_num_iterations: int = 1
    updater: Any = "sgd"
    momentum: float = 0.9
    adam_mean_decay: float = 0.9
    adam_var_decay: float = 0.999
    rho: float = 0.95
    rms_decay: float = 0.95
    epsilon: Optional[float] = None
    weight_init: Any = "xavier"
    bias_init: float = 0.0
    activation: Any = "sigmoid"
    l1: float = 0.0
    l2: float = 0.0
    dropout: float = 0.0
    use_drop_connect: bool = False
    minimize: bool = True
    gradient_normalization: Any = "none"
    gradient_normalization_threshold: float = 1.0
    dtype: str = "float32"
    dtype_policy: Optional[Any] = None
    superstep_k: int = 0
    convolution_mode: Any = "truncate"

    def inherit_into(self, layer) -> None:
        """Fill the layer's unset fields from these globals, as the
        reference's builder does (bias rate defaults to the layer's rate;
        a convolution or pooling layer's unset mode is the global one)."""
        for f in INHERITED_FIELDS:
            if getattr(layer, f, None) is None:
                setattr(layer, f, getattr(self, f))
        if layer.bias_learning_rate is None:
            layer.bias_learning_rate = layer.learning_rate
        if getattr(layer, "convolution_mode", "absent") is None:
            layer.convolution_mode = self.convolution_mode

    @staticmethod
    def from_dict(d: Optional[dict]) -> "GlobalConf":
        names = {f.name for f in dataclasses.fields(GlobalConf)}
        g = GlobalConf(**{k: v for k, v in (d or {}).items()
                          if k in names})
        if g.lr_schedule:
            g.lr_schedule = {int(k): float(v)
                             for k, v in g.lr_schedule.items()}
        return g


@dataclass
class ComputationGraphConfiguration:
    global_conf: GlobalConf = field(default_factory=GlobalConf)
    network_inputs: List[str] = field(default_factory=list)
    network_outputs: List[str] = field(default_factory=list)
    vertices: Dict[str, GraphVertexConf] = field(default_factory=dict)
    vertex_inputs: Dict[str, List[str]] = field(default_factory=dict)
    backprop_type: str = "standard"
    tbptt_fwd_length: int = 20

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
            backprop_type=str(d.get("backprop_type", "standard")).lower(),
            tbptt_fwd_length=int(d.get("tbptt_fwd_length", 20)),
        )
        conf.validate()
        return conf

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        return ComputationGraphConfiguration.from_dict(json.loads(s))


@dataclass
class MultiLayerConfiguration:
    """A sequential network: layers `layer_0 ... layer_{n-1}` in order,
    `input_preprocessors[i]` run before layer i. `backprop_type` is
    "standard" or "truncatedbptt" (chunks of `tbptt_fwd_length` steps; the
    backward length is carried, and, as in the reference engine, equal to
    the forward one in effect)."""

    global_conf: GlobalConf = field(default_factory=GlobalConf)
    layers: List[Layer] = field(default_factory=list)
    input_preprocessors: Dict[int, InputPreProcessor] = field(
        default_factory=dict)
    backprop: bool = True
    pretrain: bool = False
    backprop_type: str = "standard"
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20
    input_type: Optional[InputType] = None

    @staticmethod
    def build(global_conf: GlobalConf, layers: List[Layer],
              input_type: Optional[InputType] = None,
              input_preprocessors: Optional[Dict[int, InputPreProcessor]]
              = None, **fields) -> "MultiLayerConfiguration":
        """The reference list builder's `build()` (`neural_net.py:262-301`):
        each layer (a copy) inherits the unset global fields; with
        `input_type`, each layer i without an explicit preprocessor gets
        the one its `default_preprocessor` asks for, the preprocessor's
        output type sizes the layer's `n_in`, and the layer's output type
        feeds layer i + 1."""
        layers = [copy.deepcopy(layer) for layer in layers]
        for layer in layers:
            global_conf.inherit_into(layer)
        pre = dict(input_preprocessors or {})
        current = input_type
        if current is not None:
            for i, layer in enumerate(layers):
                if i not in pre:
                    auto = layer.default_preprocessor(current)
                    if auto is not None:
                        pre[i] = auto
                if i in pre:
                    current = pre[i].get_output_type(current)
                layer.set_n_in(current, override=True)
                current = layer.get_output_type(current)
        if "backprop_type" in fields:
            fields["backprop_type"] = str(fields["backprop_type"]).lower()
        return MultiLayerConfiguration(global_conf=global_conf, layers=layers,
                                       input_preprocessors=pre,
                                       input_type=input_type, **fields)

    @staticmethod
    def from_dict(d) -> "MultiLayerConfiguration":
        return MultiLayerConfiguration(
            global_conf=GlobalConf.from_dict(d.get("global_conf")),
            layers=[layer_from_dict(layer) for layer in d["layers"]],
            input_preprocessors={
                int(k): preprocessor_from_dict(v)
                for k, v in (d.get("input_preprocessors") or {}).items()},
            backprop=bool(d.get("backprop", True)),
            pretrain=bool(d.get("pretrain", False)),
            backprop_type=str(d.get("backprop_type", "standard")).lower(),
            tbptt_fwd_length=int(d.get("tbptt_fwd_length", 20)),
            tbptt_back_length=int(d.get("tbptt_back_length", 20)),
            input_type=InputType.from_dict(d.get("input_type")),
        )

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        return MultiLayerConfiguration.from_dict(json.loads(s))
