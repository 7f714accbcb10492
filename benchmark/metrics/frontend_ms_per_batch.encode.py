"""Device busy time under the program's ``encode.frontend`` spans (the
resample to the model's rate, the log-mel with kernel K2, HTSAT's ``bn0``
and spectrogram reshape), per traced encode batch. The PCM's copy to the
card is made before them and is not in it."""

from benchmark.spans import per_batch_ms


def read(run):
    return per_batch_ms(run, "encode.frontend")
