"""Seeded implicit-reshard fixture for ``--comms PATH`` (the port's).

A real traced program with ONE forced mid-program reshard: over the
process group of two ranks the fixture runs in (a fake one: nothing is
sent), each rank swaps its halves with the other through one
``all_to_all_single`` — a collective kind no declared layout transition
explains (the fixture declares none), so the strict fixture pass must
report exactly one ``implicit-reshard`` HIGH and the CLI must exit 1.
"""


def make_program():
    import torch
    import torch.distributed as dist

    group = dist.group.WORLD

    def body(x):
        # the seeded violation: trade halves with the neighbour rank
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x * 2.0, group=group)
        return out + 1.0

    return body, (torch.arange(8, dtype=torch.float32),)
