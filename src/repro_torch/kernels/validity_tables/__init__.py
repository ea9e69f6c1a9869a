from repro_torch.kernels.validity_tables.ops import (  # noqa: F401
    ValidityLayout, build_layout, build_tables, build_tables_plain)
