"""Device ms a training step, forward and backward, of the kernels
``attribution.py`` gives to the ``conformer.attention`` span: the
relative-position attention (its pre-LayerNorm, the q, k, v and positional
projections, the scores, the rel-shift, the softmax, the product with v and
the output projection)."""

from portbench.attribution import span_ms


def read(layer):
    return span_ms(layer, "conformer.attention")
