"""data_load_s: seconds of set-up in Testbed.load_training_data's dataset load (the PNG decode and the
upload to the card), the port's data.load_s counter."""

from portbench.harness.spans import counter


def read(run):
    return counter("data.load_s")
