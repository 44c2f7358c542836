"""sync_wait_ms.rt: host ms a frame of the program's ``t3.sync.*`` spans
inside ``t3.decode`` (``auto``'s ``torch.nonzero`` of the check's flags):
the time the host is blocked waiting for the device."""
from t3bench.lib import program


def read(ctx):
    return program.host_ms(ctx, "t3.decode", "t3.sync.")
