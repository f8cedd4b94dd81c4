"""Device ms a training step, forward and backward, of the kernels
``attribution.py`` gives to the ``conformer.conv`` span: the conv module
(its pre-LayerNorm, the pointwise convolutions, the GLU, the depthwise
convolution, BatchNorm and Swish)."""

from portbench.attribution import span_ms


def read(layer):
    return span_ms(layer, "conformer.conv")
