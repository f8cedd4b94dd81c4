"""Host ms a batch in ``DeviceBeamDecoder.decode`` (the beam, the backtrack,
the copy back and the strings) over the measured window."""


def read(layer):
    return 1e3 * layer["window"]["decode_s"]
