"""Command-line entry points of the port."""
from repro_torch.unported import not_ported

make_local_mesh = not_ported("repro.launch.make_local_mesh",
                             "A.11 (launch / multi-device)")
make_production_mesh = not_ported("repro.launch.make_production_mesh",
                                  "A.11 (launch / multi-device)")
