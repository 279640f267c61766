"""Reading reads and writing contigs: FASTA/FASTQ parsers (``fastx``), the
base encoder (``encode``) and the native parse-and-encode codec
(``native``). Host code; nothing here touches the device."""
