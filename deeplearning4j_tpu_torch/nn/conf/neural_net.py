"""The config DSL (counterpart of `deeplearning4j_tpu/nn/conf/neural_net.py`):
`NeuralNetConfiguration.builder()` sets the globals, then `.list()` builds
a `MultiLayerConfiguration` or `.graph_builder()` a
`ComputationGraphConfiguration`. At build time each layer (a copy) takes
the unset global fields; from the input types each layer's `n_in` is
inferred and the preprocessors between layer families inserted. Both
confs write the reference's JSON (`to_json`, `to_yaml`) and read it back
(`from_json`, `from_yaml`): every key is kept, and one the port does not
know raises ValueError naming it.

`MultiLayerConfiguration.build` is what `ListBuilder.build` runs; the
model builders may call it directly with a `GlobalConf`."""

from __future__ import annotations

import copy
import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.nn.conf.distributions import Distribution
from deeplearning4j_tpu_torch.nn.conf.dtype_policy import DtypePolicy
from deeplearning4j_tpu_torch.nn.conf.enums import (
    BackpropType,
    ConvolutionMode,
    GradientNormalization,
    LearningRatePolicy,
    OptimizationAlgorithm,
    Updater,
    WeightInit,
    plain,
)
from deeplearning4j_tpu_torch.nn.conf.graph import (
    GraphVertexConf,
    LayerVertex,
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
    "activation", "weight_init", "dist", "learning_rate",
    "bias_learning_rate", "l1", "l2", "dropout", "use_drop_connect",
    "bias_init", "updater", "momentum", "adam_mean_decay", "adam_var_decay",
    "rho", "rms_decay", "epsilon", "gradient_normalization",
    "gradient_normalization_threshold",
)


@dataclass
class GlobalConf:
    """The reference's global fields and defaults. Names are its JSON
    values (lower-case strings for its enums)."""

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
    dist: Optional[Distribution] = None
    activation: Any = "sigmoid"
    bias_init: float = 0.0
    l1: float = 0.0
    l2: float = 0.0
    dropout: float = 0.0
    use_drop_connect: bool = False
    minimize: bool = True
    gradient_normalization: Any = "none"
    gradient_normalization_threshold: float = 1.0
    mini_batch: bool = True
    convolution_mode: Any = "truncate"
    max_num_line_search_iterations: int = 5
    dtype: str = "float32"
    # A DtypePolicy; None derives one from `dtype` and writes nothing.
    dtype_policy: Optional[DtypePolicy] = None
    superstep_k: int = 0

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

    def to_dict(self) -> dict:
        """Every field, None values included, but the policy only when it
        is set (reference `GlobalConf.to_dict`)."""
        d = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name == "dtype_policy":
                if v is None:
                    continue
                v = DtypePolicy.of(v).to_dict()
            elif isinstance(v, Distribution):
                v = v.to_dict()
            d[f.name] = plain(v)
        return d

    @staticmethod
    def from_dict(d: Optional[dict]) -> "GlobalConf":
        d = dict(d or {})
        names = {f.name for f in dataclasses.fields(GlobalConf)}
        unknown = sorted(set(d) - names)
        if unknown:
            raise ValueError(f"global_conf has no fields {unknown}")
        if isinstance(d.get("dist"), dict):
            d["dist"] = Distribution.from_dict(d["dist"])
        if d.get("dtype_policy") is not None:
            d["dtype_policy"] = DtypePolicy.of(d["dtype_policy"])
        if d.get("lr_schedule"):
            d["lr_schedule"] = {int(k): float(v)
                                for k, v in d["lr_schedule"].items()}
        return GlobalConf(**d)


class NeuralNetConfiguration:
    """Entry point of the DSL: `NeuralNetConfiguration.builder()`."""

    @staticmethod
    def builder() -> "Builder":
        return Builder()


class Builder:
    """The global fields, one setter each (the reference builder's names,
    snake_case)."""

    def __init__(self):
        self._g = GlobalConf()

    def _set(self, name, value) -> "Builder":
        setattr(self._g, name, value)
        return self

    def seed(self, v): return self._set("seed", int(v))
    def iterations(self, v): return self._set("iterations", int(v))

    def optimization_algo(self, v):
        return self._set("optimization_algo", OptimizationAlgorithm.of(v))

    def learning_rate(self, v): return self._set("learning_rate", float(v))

    def bias_learning_rate(self, v):
        return self._set("bias_learning_rate", float(v))

    def learning_rate_decay_policy(self, v):
        return self._set("lr_policy", LearningRatePolicy.of(v))

    def lr_policy_decay_rate(self, v):
        return self._set("lr_policy_decay_rate", float(v))

    def lr_policy_power(self, v): return self._set("lr_policy_power", float(v))
    def lr_policy_steps(self, v): return self._set("lr_policy_steps", float(v))

    def learning_rate_schedule(self, schedule):
        self._g.lr_policy = LearningRatePolicy.SCHEDULE.value
        return self._set("lr_schedule", {int(k): float(v)
                                         for k, v in schedule.items()})

    def updater(self, v): return self._set("updater", Updater.of(v))
    def momentum(self, v): return self._set("momentum", float(v))
    def adam_mean_decay(self, v): return self._set("adam_mean_decay", float(v))
    def adam_var_decay(self, v): return self._set("adam_var_decay", float(v))
    def rho(self, v): return self._set("rho", float(v))
    def rms_decay(self, v): return self._set("rms_decay", float(v))
    def epsilon(self, v): return self._set("epsilon", float(v))
    def weight_init(self, v): return self._set("weight_init", WeightInit.of(v))

    def dist(self, v):
        self._g.weight_init = WeightInit.DISTRIBUTION.value
        return self._set("dist", v)

    def activation(self, v): return self._set("activation", v)
    def bias_init(self, v): return self._set("bias_init", float(v))
    def l1(self, v): return self._set("l1", float(v))
    def l2(self, v): return self._set("l2", float(v))
    def drop_out(self, v): return self._set("dropout", float(v))

    def use_drop_connect(self, v=True):
        return self._set("use_drop_connect", bool(v))

    def superstep_k(self, v): return self._set("superstep_k", int(v))
    def minimize(self, v=True): return self._set("minimize", bool(v))

    def gradient_normalization(self, v):
        return self._set("gradient_normalization",
                         GradientNormalization.of(v))

    def gradient_normalization_threshold(self, v):
        return self._set("gradient_normalization_threshold", float(v))

    def mini_batch(self, v=True): return self._set("mini_batch", bool(v))

    def convolution_mode(self, v):
        return self._set("convolution_mode", ConvolutionMode.of(v))

    def max_num_line_search_iterations(self, v):
        return self._set("max_num_line_search_iterations", int(v))

    def regularization(self, v=True):
        """The reference's no-op: l1 and l2 always apply."""
        return self

    def dtype(self, v): return self._set("dtype", str(v))

    def dtype_policy(self, v):
        return self._set("dtype_policy", DtypePolicy.of(v))

    def list(self) -> "ListBuilder":
        """A sequential network's conf."""
        return ListBuilder(copy.deepcopy(self._g))

    def graph_builder(self) -> "GraphBuilder":
        """A DAG's conf."""
        return GraphBuilder(copy.deepcopy(self._g))


def _merge_globals(layer: Layer, g: GlobalConf) -> Layer:
    """A copy of the layer with its unset fields from the globals."""
    layer = copy.deepcopy(layer)
    g.inherit_into(layer)
    return layer


class _Training:
    """The backprop setters both builders share."""

    def _init_training(self):
        self._backprop = True
        self._pretrain = False
        self._backprop_type = BackpropType.STANDARD.value
        self._tbptt_fwd = 20
        self._tbptt_back = 20

    def backprop(self, v: bool):
        self._backprop = bool(v)
        return self

    def pretrain(self, v: bool):
        self._pretrain = bool(v)
        return self

    def backprop_type(self, v):
        self._backprop_type = BackpropType.of(v)
        return self

    def t_bptt_forward_length(self, v: int):
        self._tbptt_fwd = int(v)
        return self

    def t_bptt_backward_length(self, v: int):
        self._tbptt_back = int(v)
        return self

    def _training_fields(self) -> dict:
        return dict(backprop=self._backprop, pretrain=self._pretrain,
                    backprop_type=self._backprop_type,
                    tbptt_fwd_length=self._tbptt_fwd,
                    tbptt_back_length=self._tbptt_back)


class ListBuilder(_Training):
    """A sequential network's builder: layers by index, explicit input
    preprocessors, the input type."""

    def __init__(self, g: GlobalConf):
        self._g = g
        self._layers: Dict[int, Layer] = {}
        self._preprocessors: Dict[int, InputPreProcessor] = {}
        self._input_type: Optional[InputType] = None
        self._init_training()

    def layer(self, index_or_layer, maybe_layer=None) -> "ListBuilder":
        if maybe_layer is None:
            self._layers[len(self._layers)] = index_or_layer
        else:
            self._layers[int(index_or_layer)] = maybe_layer
        return self

    def input_preprocessor(self, index: int,
                           p: InputPreProcessor) -> "ListBuilder":
        self._preprocessors[int(index)] = p
        return self

    def set_input_type(self, t: InputType) -> "ListBuilder":
        self._input_type = t
        return self

    def build(self) -> "MultiLayerConfiguration":
        n = len(self._layers)
        if sorted(self._layers) != list(range(n)):
            raise ValueError("layer indices must be contiguous from 0; got "
                             f"{sorted(self._layers)}")
        return MultiLayerConfiguration.build(
            self._g, [self._layers[i] for i in range(n)], self._input_type,
            self._preprocessors, **self._training_fields())


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
        """The list builder's `build()` (reference `neural_net.py:262-301`):
        each layer (a copy) inherits the unset global fields; with
        `input_type`, each layer i without an explicit preprocessor gets
        the one its `default_preprocessor` asks for, the preprocessor's
        output type sizes the layer's `n_in`, and the layer's output type
        feeds layer i + 1. Without it, each `n_in` left at 0 comes from
        the previous layer's `n_out`, as far as a layer's output type can
        be told from its conf."""
        layers = [_merge_globals(layer, global_conf) for layer in layers]
        pre = dict(input_preprocessors or {})
        if input_type is not None:
            current = input_type
            for i, layer in enumerate(layers):
                if i not in pre:
                    auto = layer.default_preprocessor(current)
                    if auto is not None:
                        pre[i] = auto
                if i in pre:
                    current = pre[i].get_output_type(current)
                layer.set_n_in(current, override=True)
                current = layer.get_output_type(current)
        else:
            current = None
            for layer in layers:
                if current is not None:
                    layer.set_n_in(current, override=False)
                # As in the reference (`:283-294`), a layer whose output
                # type cannot be told from its conf ends the chain.
                try:
                    current = layer.get_output_type(
                        current if current is not None
                        else InputType.feed_forward(getattr(layer, "n_in",
                                                            0)))
                except (ValueError, TypeError, ArithmeticError):
                    current = None
        if "backprop_type" in fields:
            fields["backprop_type"] = BackpropType.of(fields["backprop_type"])
        return MultiLayerConfiguration(global_conf=global_conf, layers=layers,
                                       input_preprocessors=pre,
                                       input_type=input_type, **fields)

    def to_dict(self) -> dict:
        return {
            "format": "deeplearning4j_tpu/MultiLayerConfiguration",
            "version": 1,
            "global_conf": self.global_conf.to_dict(),
            "layers": [layer.to_dict() for layer in self.layers],
            "input_preprocessors": {str(k): v.to_dict() for k, v in
                                    self.input_preprocessors.items()},
            "backprop": self.backprop,
            "pretrain": self.pretrain,
            "backprop_type": BackpropType.of(self.backprop_type),
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_back_length": self.tbptt_back_length,
            "input_type": (self.input_type.to_dict() if self.input_type
                           else None),
        }

    def to_json(self, indent=2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def to_yaml(self) -> str:
        import yaml

        return yaml.safe_dump(self.to_dict(), sort_keys=False)

    @staticmethod
    def from_dict(d) -> "MultiLayerConfiguration":
        _check_keys(d, _MLN_KEYS, "MultiLayerConfiguration")
        return MultiLayerConfiguration(
            global_conf=GlobalConf.from_dict(d.get("global_conf")),
            layers=[layer_from_dict(layer) for layer in d["layers"]],
            input_preprocessors={
                int(k): preprocessor_from_dict(v)
                for k, v in (d.get("input_preprocessors") or {}).items()},
            backprop=bool(d.get("backprop", True)),
            pretrain=bool(d.get("pretrain", False)),
            backprop_type=BackpropType.of(d.get("backprop_type",
                                                "standard")),
            tbptt_fwd_length=int(d.get("tbptt_fwd_length", 20)),
            tbptt_back_length=int(d.get("tbptt_back_length", 20)),
            input_type=InputType.from_dict(d.get("input_type")),
        )

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        return MultiLayerConfiguration.from_dict(json.loads(s))

    @staticmethod
    def from_yaml(s: str) -> "MultiLayerConfiguration":
        import yaml

        return MultiLayerConfiguration.from_dict(yaml.safe_load(s))


_MLN_KEYS = ("format", "version", "global_conf", "layers",
             "input_preprocessors", "backprop", "pretrain", "backprop_type",
             "tbptt_fwd_length", "tbptt_back_length", "input_type")
_GRAPH_KEYS = ("format", "version", "global_conf", "network_inputs",
               "network_outputs", "vertices", "vertex_inputs", "input_types",
               "backprop", "pretrain", "backprop_type", "tbptt_fwd_length",
               "tbptt_back_length")


def _check_keys(d, known, what) -> None:
    unknown = sorted(set(d) - set(known))
    if unknown:
        raise ValueError(f"{what} JSON has keys the port does not know: "
                         f"{unknown}")


class GraphBuilder(_Training):
    """A DAG's builder: named inputs, layers and vertices with their
    inputs, outputs, the inputs' types."""

    def __init__(self, g: GlobalConf):
        self._g = g
        self._inputs: List[str] = []
        self._outputs: List[str] = []
        self._vertices: Dict[str, GraphVertexConf] = {}
        self._vertex_inputs: Dict[str, List[str]] = {}
        self._input_types: Dict[str, InputType] = {}
        self._init_training()

    def add_inputs(self, *names: str) -> "GraphBuilder":
        self._inputs.extend(names)
        return self

    def set_outputs(self, *names: str) -> "GraphBuilder":
        self._outputs = list(names)
        return self

    def add_layer(self, name: str, layer: Layer, *inputs: str,
                  preprocessor: Optional[InputPreProcessor] = None
                  ) -> "GraphBuilder":
        self._vertices[name] = LayerVertex(layer=layer,
                                           preprocessor=preprocessor)
        self._vertex_inputs[name] = list(inputs)
        return self

    def add_vertex(self, name: str, vertex: GraphVertexConf,
                   *inputs: str) -> "GraphBuilder":
        self._vertices[name] = vertex
        self._vertex_inputs[name] = list(inputs)
        return self

    def set_input_types(self, *types: InputType) -> "GraphBuilder":
        for name, t in zip(self._inputs, types):
            self._input_types[name] = t
        return self

    def build(self) -> "ComputationGraphConfiguration":
        """Layers copied with the unset globals filled (the global conf
        itself is shared, as in the reference), validated, and sized from
        the input types when they are set."""
        conf = ComputationGraphConfiguration(
            global_conf=self._g,
            network_inputs=list(self._inputs),
            network_outputs=list(self._outputs),
            vertices={
                n: (LayerVertex(layer=_merge_globals(v.layer, self._g),
                                preprocessor=v.preprocessor)
                    if isinstance(v, LayerVertex) else copy.deepcopy(v))
                for n, v in self._vertices.items()},
            vertex_inputs={n: list(v)
                           for n, v in self._vertex_inputs.items()},
            input_types=dict(self._input_types),
            **self._training_fields())
        conf.validate()
        if self._input_types:
            conf.infer_shapes()
        return conf


@dataclass
class ComputationGraphConfiguration:
    global_conf: GlobalConf = field(default_factory=GlobalConf)
    network_inputs: List[str] = field(default_factory=list)
    network_outputs: List[str] = field(default_factory=list)
    vertices: Dict[str, GraphVertexConf] = field(default_factory=dict)
    vertex_inputs: Dict[str, List[str]] = field(default_factory=dict)
    input_types: Dict[str, InputType] = field(default_factory=dict)
    backprop: bool = True
    pretrain: bool = False
    backprop_type: str = "standard"
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20

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
        """Kahn sort with the reference's tie order: the vertices with no
        vertex inputs sorted, then each dependent appended as its last
        input is placed (reference `neural_net.py:488-509`)."""
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

    def infer_shapes(self) -> Dict[str, InputType]:
        """Each layer vertex's `n_in` from the input types, with the
        preprocessor its layer asks for where it has none (reference
        `infer_shapes`); returns every vertex's output type."""
        types: Dict[str, InputType] = dict(self.input_types)
        for name in self.topological_order():
            vertex = self.vertices[name]
            in_types = [types[i] for i in self.vertex_inputs[name]]
            if isinstance(vertex, LayerVertex):
                it = in_types[0]
                if vertex.preprocessor is None:
                    vertex.preprocessor = vertex.layer.default_preprocessor(
                        it)
                if vertex.preprocessor is not None:
                    it = vertex.preprocessor.get_output_type(it)
                vertex.layer.set_n_in(it, override=True)
                types[name] = vertex.layer.get_output_type(it)
            else:
                types[name] = vertex.get_output_type(*in_types)
        return types

    def to_dict(self) -> dict:
        return {
            "format": "deeplearning4j_tpu/ComputationGraphConfiguration",
            "version": 1,
            "global_conf": self.global_conf.to_dict(),
            "network_inputs": self.network_inputs,
            "network_outputs": self.network_outputs,
            "vertices": {n: v.to_dict() for n, v in self.vertices.items()},
            "vertex_inputs": self.vertex_inputs,
            "input_types": {n: t.to_dict()
                            for n, t in self.input_types.items()},
            "backprop": self.backprop,
            "pretrain": self.pretrain,
            "backprop_type": BackpropType.of(self.backprop_type),
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_back_length": self.tbptt_back_length,
        }

    def to_json(self, indent=2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def to_yaml(self) -> str:
        import yaml

        return yaml.safe_dump(self.to_dict(), sort_keys=False)

    @staticmethod
    def from_dict(d) -> "ComputationGraphConfiguration":
        _check_keys(d, _GRAPH_KEYS, "ComputationGraphConfiguration")
        conf = ComputationGraphConfiguration(
            global_conf=GlobalConf.from_dict(d.get("global_conf")),
            network_inputs=list(d["network_inputs"]),
            network_outputs=list(d["network_outputs"]),
            vertices={n: vertex_from_dict(v)
                      for n, v in d["vertices"].items()},
            vertex_inputs={n: list(v) for n, v in d["vertex_inputs"].items()},
            input_types={n: InputType.from_dict(t)
                         for n, t in (d.get("input_types") or {}).items()},
            backprop=bool(d.get("backprop", True)),
            pretrain=bool(d.get("pretrain", False)),
            backprop_type=BackpropType.of(d.get("backprop_type",
                                                "standard")),
            tbptt_fwd_length=int(d.get("tbptt_fwd_length", 20)),
            tbptt_back_length=int(d.get("tbptt_back_length", 20)),
        )
        conf.validate()
        return conf

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        return ComputationGraphConfiguration.from_dict(json.loads(s))

    @staticmethod
    def from_yaml(s: str) -> "ComputationGraphConfiguration":
        import yaml

        return ComputationGraphConfiguration.from_dict(yaml.safe_load(s))
