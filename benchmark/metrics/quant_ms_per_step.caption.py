"""Device busy time a decode step spends in the activation quantize
(``layer.quant``: ``ops/quant.py::quant_act``) and the int8 GEMMs'
rescale, cast and bias add (``layer.rescale``), in the blocks (outside
``decode.logits``), per traced step."""

from benchmark.spans import per_step_ms


def read(run):
    return per_step_ms(run, "quant")
