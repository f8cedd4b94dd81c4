"""Device ms a training step, forward and backward, of the kernels
``attribution.py`` gives to the ``conformer.subsample`` span: the two
stride-2 convolutions, the Linear over (channel, mel) and the scaling."""

from portbench.attribution import span_ms


def read(layer):
    return span_ms(layer, "conformer.subsample")
