"""The plain reference: NumPy and PyTorch, nothing of the port, no JAX.

* :mod:`.fptable` -- the single-probe fingerprint table (hashes, seed
  search, placement) rebuilt from the keys, and the restricted k-mer count
  of code reads against it, windows on the read's own strand.
* :mod:`.exact` -- the same count with no table: each window looked up in
  the sorted keys (what the count cell holds the program to).
* :mod:`.treedb`, :mod:`.cst`, :mod:`.l2vote` -- frozen copies of the
  identify stages that follow the count (the DB loader, the CST search, the
  layer-2 vote and the report writers), run on the reference's own counts.
"""
