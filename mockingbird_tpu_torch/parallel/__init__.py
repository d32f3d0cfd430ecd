"""Data parallelism across processes (``multihost``), the ranks as a
``('data', 'model')`` mesh (``mesh``) and tensor-parallel placement rules
(``shardings``), on ``torch.distributed``."""
