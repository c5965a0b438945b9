"""COMET reasoning generation over the prepared VCG index:
``python -m kmbart_tpu_torch.scripts.prepare_vcg_reason``.

Twin of scripts/prepare_vcg_reason.py: the caption datasets' driver, with
the VCG event as the conditioning text.
"""

from kmbart_tpu_torch.scripts.reason_common import run


def main(argv=None):
    run(caption_key="event", annot_help="directory with the prepared VCG {split}.json files",
        argv=argv)


if __name__ == "__main__":
    main()
