"""Parallel decompositions of the sweep: genome windows on one card
(``windows``) and across the ranks of a ``torch.distributed`` job
(``launch``, ``mesh``, ``blocked_mesh``, ``sharded_io``)."""
