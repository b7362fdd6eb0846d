"""Tools of the port, each run as ``python -m optflow_tpu_torch.tools.<name>``:
the job generator ``gen_pairs`` and the offline match uploader
``upload_matches`` (both can read from a live render-ws through
``sinks/render_client.py``), and two measurement tools, ``kernel_ablate``
(what the TV-L1 iteration spends on each class of cost) and ``smem_cap``
(how much shared memory a thread block really gets). :mod:`.probes` holds the
counterparts of the repository's solver probes (``tools/probes/``)."""
