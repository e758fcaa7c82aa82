"""StructureFind facade — drop-in API parity with the reference class.

Mirrors ``HiCHap.StructureFind.StructureFind`` (StructureFind.py:27-106):
construct with (cooler_fil, Res, Allelic[, GapFile, Loop_ratio,
Loop_strength]) and call ``run_Compartment`` / ``run_TADs`` / ``run_Loops``.
Internally dispatches to the device models (compartment.py / tads.py /
loops.py).
"""

from __future__ import annotations

from typing import Optional

from .compartment import run_compartment
from .loops import run_loops
from .tads import run_tads


class StructureFind:
    def __init__(self, cooler_fil: str, Res: int, Allelic,
                 GapFile: Optional[str] = None, Loop_ratio: float = 0.6,
                 Loop_strength: float = 16):
        # Accept both "file.cool" and "file.cool::res" (the reference builds
        # the URI itself, StructureFind.py:101).
        self.cooler_fil = cooler_fil.split("::")[0]
        self.Res = Res
        self.Allelic = Allelic
        self.Gap_file = GapFile
        self.ratio = Loop_ratio
        self.LoopStrength = Loop_strength

    def run_Compartment(self, OutPath: str, plot: bool = True, MS: str = "IF",
                        SA: bool = False, Tranditional_PC_file=None,
                        pca_method: str = "subspace", selector: str = "new"):
        # selector='legacy' reproduces the reference's Select_PC
        # (StructureFind.py:345-372) instead of Select_PC_new.
        return run_compartment(
            self.cooler_fil, self.Res, self.Allelic, OutPath, sliding=SA,
            traditional_pc_file=Tranditional_PC_file, plot=plot,
            pca_method=pca_method, ms=MS, selector=selector)

    def run_TADs(self, OutPath: str, **kwargs):
        return run_tads(
            self.cooler_fil, self.Res, self.Allelic, OutPath,
            min_tad=kwargs.get("minTAD", 200_000),
            max_tad=kwargs.get("maxTAD", 4_000_000),
            state_num=kwargs.get("state_num", 3),
            window=kwargs.get("window", 600_000),
            test_type=kwargs.get("test_type", "ttest"),
            plot=kwargs.get("plot", True))

    def run_Loops(self, OutPath: str, plot: bool = False):
        return run_loops(
            self.cooler_fil, self.Res, self.Allelic, OutPath,
            gap_file=self.Gap_file, loop_ratio=self.ratio,
            loop_strength=self.LoopStrength, plot=plot)
