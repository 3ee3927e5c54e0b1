"""ResNet-50 as a ComputationGraph (counterpart of
`deeplearning4j_tpu/models/resnet.py`), built through the graph builder
as the reference builds it, in both forms of the bottleneck: five
vertices per block (`_bottleneck`: conv/BN pairs, an elementwise add and a
relu) or one fused `BottleneckBlock` layer (`_bottleneck_fused`). The
builder sizes each layer from the input type (NHWC, TF-style SAME or
TRUNCATE output sizes)."""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf.graph import ElementWiseVertex
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ActivationLayer,
    BatchNormalization,
    BottleneckBlock,
    ConvolutionLayer,
    GlobalPoolingLayer,
    OutputLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.nn.conf.neural_net import (
    ComputationGraphConfiguration,
    NeuralNetConfiguration,
)


def _conv_bn(b, name, inp, n_out, kernel, stride, activation="relu",
             mode="same"):
    b.add_layer(
        f"{name}_conv",
        ConvolutionLayer(kernel_size=kernel, stride=stride, n_out=n_out,
                         convolution_mode=mode, activation="identity",
                         has_bias=False),
        inp)
    b.add_layer(f"{name}_bn", BatchNormalization(activation=activation),
                f"{name}_conv")
    return f"{name}_bn"


def _bottleneck(b, name, inp, filters, stride, project: bool):
    """Bottleneck residual block: 1x1 -> 3x3 -> 1x1 (+ projection)."""
    f1, f2, f3 = filters, filters, filters * 4
    x = _conv_bn(b, f"{name}_a", inp, f1, (1, 1), stride)
    x = _conv_bn(b, f"{name}_b", x, f2, (3, 3), (1, 1))
    x = _conv_bn(b, f"{name}_c", x, f3, (1, 1), (1, 1), activation="identity")
    if project:
        shortcut = _conv_bn(b, f"{name}_proj", inp, f3, (1, 1), stride,
                            activation="identity")
    else:
        shortcut = inp
    b.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), x, shortcut)
    b.add_layer(f"{name}_relu", ActivationLayer(activation="relu"),
                f"{name}_add")
    return f"{name}_relu"


def _bottleneck_fused(b, name, inp, filters, stride, project: bool):
    """The same bottleneck as one fused layer (kernels/bottleneck_block.py)."""
    b.add_layer(
        f"{name}_block",
        BottleneckBlock(filters=filters, stride=stride, project=project,
                        activation="relu"),
        inp)
    return f"{name}_block"


def resnet50(n_classes: int = 1000, image: int = 224, channels: int = 3,
             seed: int = 123, lr: float = 0.1, dtype: str = "bfloat16",
             fused_blocks: bool = False) -> ComputationGraphConfiguration:
    """The reference's ResNet-50: Nesterovs (momentum 0.9) at `lr`, relu
    init, l2 1e-4; stem 7x7/2 conv + BN + 3x3/2 max pool, four stages of
    (3, 4, 6, 3) bottlenecks at (64, 128, 256, 512) filters, global average
    pool, softmax output. `dtype="bfloat16"` is `mixed_bfloat16`."""
    b = (NeuralNetConfiguration.builder()
         .seed(seed).learning_rate(lr).updater("nesterovs").momentum(0.9)
         .weight_init("relu").l2(1e-4).dtype(dtype)
         .graph_builder()
         .add_inputs("input"))
    x = _conv_bn(b, "stem", "input", 64, (7, 7), (2, 2))
    b.add_layer("stem_pool",
                SubsamplingLayer(pooling_type="max", kernel_size=(3, 3),
                                 stride=(2, 2), convolution_mode="same"),
                x)
    x = "stem_pool"
    stages = [(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)]
    block = _bottleneck_fused if fused_blocks else _bottleneck
    for si, (filters, blocks, first_stride) in enumerate(stages):
        for bi in range(blocks):
            stride = (first_stride, first_stride) if bi == 0 else (1, 1)
            x = block(b, f"s{si}_b{bi}", x, filters, stride,
                      project=(bi == 0))
    b.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), x)
    b.add_layer("fc",
                OutputLayer(n_out=n_classes, activation="softmax",
                            loss_function="mcxent", weight_init="xavier"),
                "avgpool")
    return (b.set_outputs("fc")
            .set_input_types(InputType.convolutional(image, image, channels))
            .build())
