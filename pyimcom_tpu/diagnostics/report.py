"""
Validation report: a multi-section PDF plus machine-readable data blocks.

Counterpart of reference src/pyimcom/diagnostics/report.py.  The reference
compiles LaTeX with pdflatex; this environment has no TeX, so the report is
rendered directly to PDF with matplotlib (PdfPages) and the machine-readable
blocks keep the reference's ``$$$START <name> ... $$$END <name>`` wrapping
(reference test_pyimcom.py:345-377 parses them back) in a sidecar .txt file.
"""

from __future__ import annotations

import os
import time

import numpy as np


class ReportSection:
    """
    One report section: builds figures and machine-readable data.

    Subclasses implement build(), appending matplotlib figures to
    self.figures and text data to self.datablocks[name].
    """

    def __init__(self, report: "ValidationReport"):
        self.report = report
        self.figures = []
        self.datablocks = {}
        self.title = type(self).__name__

    def build(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def add_datablock(self, name: str, text: str):
        self.datablocks[name] = text


class ValidationReport:
    """
    Collects sections and writes <outstem>_report.pdf + <outstem>_data.txt.

    Parameters
    ----------
    fname : a block file of the mosaic under validation.
    outstem : output file stem.
    clear_all : remove previous outputs first.
    """

    def __init__(self, fname, outstem, clear_all: bool = False):
        self.fname = str(fname)
        self.outstem = str(outstem)
        self.sections = []
        if clear_all:
            for suffix in ("_report.pdf", "_data.txt"):
                try:
                    os.remove(self.outstem + suffix)
                except FileNotFoundError:
                    pass

    def addsections(self, sections):
        self.sections.extend(sections)

    def compile(self) -> str:
        """Render all sections; returns the PDF path."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib.backends.backend_pdf import PdfPages

        pdf_path = self.outstem + "_report.pdf"
        txt_path = self.outstem + "_data.txt"
        with PdfPages(pdf_path) as pdf:
            # title page
            fig = plt.figure(figsize=(8.5, 11))
            fig.text(0.5, 0.7, "PyIMCOM Validation Report", ha="center",
                     fontsize=20)
            fig.text(0.5, 0.6, self.fname, ha="center", fontsize=9)
            fig.text(0.5, 0.55, time.strftime("%Y-%m-%d %H:%M:%S UTC",
                                              time.gmtime()), ha="center")
            fig.text(0.5, 0.45, "\n".join(s.title for s in self.sections),
                     ha="center", fontsize=11)
            pdf.savefig(fig)
            plt.close(fig)
            from ..config import format_axis

            for s in self.sections:
                for f in s.figures:
                    for ax in f.get_axes():
                        # house style (reference config.py:1252-1275); image
                        # panels keep their own tick/grid choices
                        if not ax.get_images():
                            format_axis(ax)
                    pdf.savefig(f)
                    plt.close(f)

        with open(txt_path, "w") as f:
            for s in self.sections:
                for name, text in s.datablocks.items():
                    f.write(f"$$$START {name}\n{text}\n$$$END {name}\n")
        return pdf_path


def pull_from_file(infile):
    """Parse the machine-readable data blocks back into a dict
    (same contract as reference test_pyimcom.pull_from_file)."""
    with open(infile) as f:
        lines = f.readlines()
    out = {}
    name = None
    info = ""
    for line in lines:
        if line.startswith("$$$START "):
            name = line.split()[1]
            info = ""
            continue
        if line.startswith("$$$END "):
            out[name] = info
            name = None
            continue
        if name is not None:
            info += line
    return out
