"""Window, rank and quantile primitives, and the ADMM segment kernel."""
