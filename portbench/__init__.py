"""The benchmark of ``ipopt_torch`` on the card: see README.md."""
