"""Entry points of the port: prove-while-train (`train`, `steps`)."""
