"""Residual-restriction and prolongation-correction's share of their bytes
roofline (kernels B, C, F and G), in %: the compulsory bytes of every
transfer of a solve over the device time of the kernels mapped to the
stage "transfer", at the card's HBM peak."""


def read(ctx):
    return ctx.roofline_share("transfer")
