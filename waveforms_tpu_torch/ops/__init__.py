"""Host lowering, plans and the synthesis entry points over the kernels.

Submodules are imported where they are used; importing this package loads
nothing beyond numpy.
"""
