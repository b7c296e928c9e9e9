"""Measurement scripts of the port, one module per script of the JAX
package's ``scripts/`` directory, each run as
``python -m minlz_tpu_torch.scripts.<name> [--device cuda|cpu] ...``.

``kernel_probe``, ``exec_probe`` and ``ablate_exec`` drive the probe kernels
of ``ops/probe.py``; ``profile_decode``, ``probe_v2``, ``rec_stats``,
``enc_probe`` and ``emit_probe`` time and count the codec's own stages.  On
the card every printed line ends in the card's name and power limit; with
``--device cpu`` the plain torch versions run and the times say nothing
about a device.
"""
