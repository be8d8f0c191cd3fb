"""Communication (port of ``deepspeed_tpu/comm``): the ``deepspeed.comm``
functional API over ``torch.distributed`` (``comm.py``) and the mesh axes,
of which the port has the data axis (``mesh.py``)."""
