"""The plain reference that decides ``correct``: frozen plain operations
(``ops``), the LM (``lm``) and a frame's stages (``frame``). It imports
nothing of the port."""
