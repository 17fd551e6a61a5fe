"""ASE-protocol calculators."""
