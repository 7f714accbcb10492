"""Device busy time under the program's spans ``decode.mapper`` (the MLP
mapper and the prefix assembly) and ``decode.prefill`` (the cache, the
prefill with its cache quantize, the first argmax), per traced batch."""

from benchmark.spans import per_batch_ms


def read(run):
    return per_batch_ms(run, "decode.mapper", "decode.prefill")
