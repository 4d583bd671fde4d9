"""Binarization: raw wavs and ``transcriptions.csv`` -> ``{prefix}.data`` /
``{prefix}.meta``, ``spk_map.json`` and ``dictionary.txt`` (the JAX
package's ``preprocessing/``, on the host, with RMVPE and the vocal-remover
net on the card)."""
