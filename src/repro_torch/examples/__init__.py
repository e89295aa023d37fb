"""The reference's five examples on the port, one module each.

Run as ``python -m repro_torch.examples.<name>`` (``quickstart``,
``inverted_index``, ``serve_lm``, ``moe_balance``, ``train_lm``). Each
takes ``--device`` (default: the current CUDA device; ``cpu`` when asked)
and ``--report PATH`` (the numbers it printed, and the kernel launches it
made, as JSON), and prints what the reference's script prints, at its
sizes and seeds. Each is written in sections, functions the tests call;
``main(argv=None)`` drives them and returns the numbers it printed.

Where they differ from the reference: the port has no ``jit_misses``
(nothing is traced), so the lines that print it leave it out; a trainer
takes ``device=`` where the reference takes ``single_device_mesh()``; and
weights come from ``init_model(cfg, seed=0, device=)``, so losses and
generated tokens are not the reference's numbers. Plans, MapReduce values
and counts, reuse decisions and balance ratios are: their zipf draws go
through ``repro_torch.data.synthetic.zipf`` (numpy 2.0's sampler), so a
newer numpy does not change them.
"""
