"""Host syncs a call: the warnings of torch.cuda.set_sync_debug_mode("warn")
over one call of each pool pair after the traced window, an exact count."""


def read(ctx):
    return ctx.host_syncs / ctx.sync_calls
