"""Smoothing's share of its bytes roofline (kernels A and E), in %: the
compulsory bytes of every smoothing call of a solve over the device time
of the kernels mapped to the stage "smooth", at the card's HBM peak."""


def read(ctx):
    return ctx.roofline_share("smooth")
